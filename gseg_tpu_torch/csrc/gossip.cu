// One T-step pass of the turbo path's step fixpoints, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/gossip.py:_strip_call_skip with its three
// step variants used by the speed path: compmin (_compmin_prepare +
// _compmin_step), the dist-free label flood (_allow_prepare +
// _labelnd_step) and the value flood (_compmin_prepare + _value_step).
//
// What it computes: each variant is a semilattice join over an 8-connected
// adjacency given per pixel as 8 direction bits (same label, or the packed
// allow bits of the flood):
//   compmin: lexmin of (bw, be) and max of sz;
//   labelnd: min of the label and max of idf;
//   value:   min of val.
// The host repeats passes until one changes no pixel; that certifies the
// global one-step fixpoint (monotone steps: if a pass ends where it began,
// every step inside it was a no-op).
//
// Design. The Pallas kernel walks row strips in order and patches the
// downward halo from the strip it just computed; a CUDA grid runs in no
// order, so:
//   - each pass is Jacobi: it reads one copy of the fields and writes the
//     other, so no block ever sees a neighbour's half-written output;
//   - a block owns a TILE x TILE interior and loads a T-pixel halo on all
//     four sides; after T in-shared-memory steps exactly the interior is
//     exact, and only the interior is written back;
//   - inside a tile every step is Jacobi too: each thread computes its
//     pixels' new values into registers from the shared copy, then all
//     threads write back between two barriers, so a (bw, be) pair is never
//     read torn;
//   - out-of-image and out-of-slab neighbours never contribute: the
//     direction bits are masked by explicit bounds checks (the Pallas roll
//     wraps, which is where its round-3 leak came from).
//
// Bound on the H100: each pass reads 2-4 int32/float32 planes and writes
// 1-3 (8 MB each at 1080p), with a (TILE+2T)^2 / TILE^2 = 2.25x halo
// re-read that the L2 cache mostly absorbs; the compute is a few integer
// compares per direction. So a pass is memory- and launch-bound, and the
// pass count is set by component diameter / T. Strip skipping (converged
// strips stay idle) and on-device loop control are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 8;                 // steps per pass (_pick_t at w < 2560)
constexpr int TILE = 32;             // interior side owned by one block
constexpr int SLAB = TILE + 2 * T;   // loaded side, halo included
constexpr int NPIX = SLAB * SLAB;
constexpr int THREADS = 256;
constexpr int PPT = (NPIX + THREADS - 1) / THREADS;  // pixels per thread

// DIRS8 order: E, S, SE, NE, then the reverses W, N, NW, SW.
// dy: 0, 1, 1, 1, 0, -1, -1, -1; dx: 1, 0, 1, -1, -1, 0, -1, 1.
__host__ __device__ constexpr int dir_dy(int d) {
    return (d & 3) == 0 ? 0 : (d < 4 ? 1 : -1);
}
__host__ __device__ constexpr int dir_dx(int d) {
    return (d < 4 ? 1 : -1) * ((d & 3) == 1 ? 0 : ((d & 3) == 3 ? -1 : 1));
}

struct CompminOp {  // fields: bw (f32 bits), be (i32), sz (i32)
    static constexpr int NRW = 3;
    static constexpr bool RO_LABEL = true;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7f800000u : (k == 1 ? 0x7fffffffu : 0u);
    }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        const float cw = __uint_as_float(c[0]);
        const float nw = __uint_as_float(f[0][n]);
        const int ne = static_cast<int>(f[1][n]);
        if (nw < cw || (nw == cw && ne < static_cast<int>(c[1]))) {
            c[0] = f[0][n];
            c[1] = f[1][n];
        }
        if (static_cast<int>(f[2][n]) > static_cast<int>(c[2])) c[2] = f[2][n];
    }
};

struct LabelndOp {  // fields: Lc (i32), idf (f32 bits)
    static constexpr int NRW = 2;
    static constexpr bool RO_LABEL = false;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7fffffffu : 0u;
    }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        if (static_cast<int>(f[0][n]) < static_cast<int>(c[0])) c[0] = f[0][n];
        if (__uint_as_float(f[1][n]) > __uint_as_float(c[1])) c[1] = f[1][n];
    }
};

struct ValueOp {  // field: val (i32)
    static constexpr int NRW = 1;
    static constexpr bool RO_LABEL = true;
    __device__ static uint32_t fill(int) { return 0x7fffffffu; }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        if (static_cast<int>(f[0][n]) < static_cast<int>(c[0])) c[0] = f[0][n];
    }
};

template <int N>
struct Fields {
    const uint32_t* in[N];
    uint32_t* out[N];
};

// ro: the (H, W) label plane (RO_LABEL) or the packed allow bits.
template <class Op>
__global__ void __launch_bounds__(THREADS)
fixpoint_pass(const int32_t* __restrict__ ro, Fields<Op::NRW> fl, int h,
              int w, int32_t* __restrict__ changed) {
    __shared__ uint32_t f[Op::NRW][NPIX];
    __shared__ int32_t lab[Op::RO_LABEL ? NPIX : 1];
    __shared__ int block_changed;

    const int y0 = blockIdx.y * TILE - T;
    const int x0 = blockIdx.x * TILE - T;
    if (threadIdx.x == 0) block_changed = 0;

    uint32_t bits[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int i = threadIdx.x + j * THREADS;
        bits[j] = 0;
        if (i < NPIX) {
            const int gy = y0 + i / SLAB, gx = x0 + i % SLAB;
            const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
            const size_t g = static_cast<size_t>(gy) * w + gx;
#pragma unroll
            for (int k = 0; k < Op::NRW; ++k)
                f[k][i] = inside ? fl.in[k][g] : Op::fill(k);
            if constexpr (Op::RO_LABEL) lab[i] = inside ? ro[g] : -1;
            else if (inside) bits[j] = static_cast<uint32_t>(ro[g]) & 0xffu;
        }
    }
    __syncthreads();

    // Direction bits, once per pass: the neighbour lies in the slab and in
    // the image (and, for label planes, has the same label).
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i >= NPIX) continue;
        const int ly = i / SLAB, lx = i % SLAB;
        const int gy = y0 + ly, gx = x0 + lx;
        uint32_t b = 0;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
#pragma unroll
            for (int d = 0; d < 8; ++d) {
                const int ny = ly + dir_dy(d), nx = lx + dir_dx(d);
                const int gny = gy + dir_dy(d), gnx = gx + dir_dx(d);
                bool ok = ny >= 0 && ny < SLAB && nx >= 0 && nx < SLAB &&
                          gny >= 0 && gny < h && gnx >= 0 && gnx < w;
                if constexpr (Op::RO_LABEL)
                    ok = ok && lab[ny * SLAB + nx] == lab[i];
                else ok = ok && ((bits[j] >> d) & 1u);
                b |= static_cast<uint32_t>(ok) << d;
            }
        }
        bits[j] = b;
    }

    for (int s = 0; s < T; ++s) {
        uint32_t nv[PPT][Op::NRW];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const int i = threadIdx.x + j * THREADS;
            if (i >= NPIX) continue;
#pragma unroll
            for (int k = 0; k < Op::NRW; ++k) nv[j][k] = f[k][i];
#pragma unroll
            for (int d = 0; d < 8; ++d)
                if ((bits[j] >> d) & 1u)
                    Op::join(nv[j], f, i + dir_dy(d) * SLAB + dir_dx(d));
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const int i = threadIdx.x + j * THREADS;
            if (i >= NPIX) continue;
#pragma unroll
            for (int k = 0; k < Op::NRW; ++k) f[k][i] = nv[j][k];
        }
        __syncthreads();
    }

    bool any = false;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i >= NPIX) continue;
        const int ly = i / SLAB, lx = i % SLAB;
        if (ly < T || ly >= T + TILE || lx < T || lx >= T + TILE) continue;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const size_t g = static_cast<size_t>(gy) * w + gx;
#pragma unroll
        for (int k = 0; k < Op::NRW; ++k) {
            const uint32_t v = f[k][i];
            any = any || v != fl.in[k][g];
            fl.out[k][g] = v;
        }
    }
    if (any) block_changed = 1;
    __syncthreads();
    if (threadIdx.x == 0 && block_changed) atomicOr(changed, 1);
}

template <class Op>
int launch(const void* ro, Fields<Op::NRW> fl, int h, int w, void* changed,
           void* stream) {
    const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
    fixpoint_pass<Op><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ro), fl, h, w,
        static_cast<int32_t*>(changed));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gseg_gossip_steps() { return T; }

int gseg_compmin_pass(const void* L, const void* bw_in, const void* be_in,
                      const void* sz_in, void* bw_out, void* be_out,
                      void* sz_out, int h, int w, void* changed,
                      void* stream) {
    Fields<3> fl{{static_cast<const uint32_t*>(bw_in),
                  static_cast<const uint32_t*>(be_in),
                  static_cast<const uint32_t*>(sz_in)},
                 {static_cast<uint32_t*>(bw_out), static_cast<uint32_t*>(be_out),
                  static_cast<uint32_t*>(sz_out)}};
    return launch<CompminOp>(L, fl, h, w, changed, stream);
}

int gseg_labelnd_pass(const void* allow, const void* L_in, const void* idf_in,
                      void* L_out, void* idf_out, int h, int w, void* changed,
                      void* stream) {
    Fields<2> fl{{static_cast<const uint32_t*>(L_in),
                  static_cast<const uint32_t*>(idf_in)},
                 {static_cast<uint32_t*>(L_out), static_cast<uint32_t*>(idf_out)}};
    return launch<LabelndOp>(allow, fl, h, w, changed, stream);
}

int gseg_value_pass(const void* L, const void* val_in, void* val_out, int h,
                    int w, void* changed, void* stream) {
    Fields<1> fl{{static_cast<const uint32_t*>(val_in)},
                 {static_cast<uint32_t*>(val_out)}};
    return launch<ValueOp>(L, fl, h, w, changed, stream);
}

}  // extern "C"
