// One T-step pass of the turbo path's step fixpoints, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/gossip.py:_strip_call_skip with the five
// step variants of the speed path: compmin (_compmin_prepare +
// _compmin_step), the label flood with the BFS distance riding along
// (_allow_prepare + _label_step), the dist-free label flood
// (_allow_prepare + _labelnd_step), the value flood (_compmin_prepare +
// _value_step) and the subtree sums (_subsum_prepare + _subsum_step).
//
// What it computes. Four variants are semilattice joins over an
// 8-connected adjacency given per pixel as 8 direction bits (same label,
// or the packed allow bits of the floods):
//   compmin:   lexmin of (bw, be) and max of sz;
//   labeldist: lexmin of (Lc, dist), a neighbour offering (nL, nd + 1)
//              (nd + 1 saturating at BIG), and max of idf. This is the
//              reference's adopt (strictly smaller label) / relax (equal
//              label, smaller distance) chain written as one lexmin;
//   labelnd:   min of the label and max of idf;
//   value:     min of val.
// Their fixpoint is unique (per allow component: the min label, then the
// BFS distance from that label's seeds), and every step only lowers (lex)
// mins and raises maxes, so a pass that ends where it began changed
// nothing at any step: the host's exit on a pass with no change certifies
// the global one-step fixpoint, and a Jacobi pass reaches the same fixpoint
// as the reference's chained in-step updates.
//
// subsum is not a join: s <- 1 + sum of s over the children, where the
// children of p are the neighbours whose parent direction (pdir, 0-7;
// 8 = none) points at p. Each new value starts from 1 (Op::init), not from
// the old one. The map F(s) = 1 + A s is affine with A nilpotent (the
// parent tree is acyclic: a parent has dist one less), so its fixpoint s*
// is unique, and F^T(s) = s implies s = s*: with e = s - s*,
// F^T(s) - s* = A^T e, so e = A^T e = A^(nT) e = 0. Nilpotency, not
// monotonicity, makes the no-change exit a certificate here.
//
// Design. The Pallas kernel walks row strips in order and patches the
// downward halo from the strip it just computed; a CUDA grid runs in no
// order, so:
//   - each pass is Jacobi: it reads one copy of the fields and writes the
//     other, so no block ever sees a neighbour's half-written output;
//   - a block owns a TILE x TILE interior and loads a T-pixel halo on all
//     four sides; after T in-shared-memory steps exactly the interior is
//     exact, and only the interior is written back. (Slab-edge values are
//     wrong after one step, wrong values travel one pixel per step; for
//     subsum the missing out-of-slab children err the same way);
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
// pass count is set by component diameter (tree depth for subsum) / T.
// Strip skipping (converged strips stay idle) and on-device loop control
// are later work.

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

// What the read-only plane holds: a label plane (neighbours join when their
// labels are equal), packed allow bits (bit d: join with neighbour d), or
// parent directions (neighbour d is a child when its pdir is d's reverse).
enum class Ro { kLabel, kAllow, kPdir };

// Each Op: NRW read-write 32-bit fields, their out-of-image fill words, the
// kind of read-only plane, init (a pixel's new value before the joins) and
// join (fold in neighbour n). The joins start from the pixel's old value.
struct KeepOwn {
    template <int N>
    __device__ static void init(uint32_t (&c)[N], uint32_t (*f)[NPIX],
                                int i) {
#pragma unroll
        for (int k = 0; k < N; ++k) c[k] = f[k][i];
    }
};

struct CompminOp : KeepOwn {  // fields: bw (f32 bits), be (i32), sz (i32)
    static constexpr int NRW = 3;
    static constexpr Ro RO = Ro::kLabel;
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

constexpr int BIGDIST = 1 << 30;  // dist of a pixel no seed has reached

struct LabelDistOp : KeepOwn {  // fields: Lc (i32), idf (f32 bits), dist (i32)
    static constexpr int NRW = 3;
    static constexpr Ro RO = Ro::kAllow;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7fffffffu
                      : (k == 1 ? 0u : static_cast<uint32_t>(BIGDIST));
    }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        const int nl = static_cast<int>(f[0][n]);
        const int nd = static_cast<int>(f[2][n]);
        const int cand = nd >= BIGDIST ? BIGDIST : nd + 1;
        const int cl = static_cast<int>(c[0]);
        if (nl < cl || (nl == cl && cand < static_cast<int>(c[2]))) {
            c[0] = f[0][n];
            c[2] = static_cast<uint32_t>(cand);
        }
        if (__uint_as_float(f[1][n]) > __uint_as_float(c[1])) c[1] = f[1][n];
    }
};

struct LabelndOp : KeepOwn {  // fields: Lc (i32), idf (f32 bits)
    static constexpr int NRW = 2;
    static constexpr Ro RO = Ro::kAllow;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7fffffffu : 0u;
    }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        if (static_cast<int>(f[0][n]) < static_cast<int>(c[0])) c[0] = f[0][n];
        if (__uint_as_float(f[1][n]) > __uint_as_float(c[1])) c[1] = f[1][n];
    }
};

struct ValueOp : KeepOwn {  // field: val (i32)
    static constexpr int NRW = 1;
    static constexpr Ro RO = Ro::kLabel;
    __device__ static uint32_t fill(int) { return 0x7fffffffu; }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        if (static_cast<int>(f[0][n]) < static_cast<int>(c[0])) c[0] = f[0][n];
    }
};

struct SubsumOp {  // field: s (i32); the bits mark the children; s starts at 1
    static constexpr int NRW = 1;
    static constexpr Ro RO = Ro::kPdir;
    __device__ static uint32_t fill(int) { return 0u; }
    __device__ static void init(uint32_t (&c)[NRW], uint32_t (*)[NPIX],
                                int) {
        c[0] = 1u;
    }
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        c[0] += f[0][n];
    }
};

template <int N>
struct Fields {
    const uint32_t* in[N];
    uint32_t* out[N];
};

// ro: the (H, W) read-only plane of kind Op::RO.
template <class Op>
__global__ void __launch_bounds__(THREADS)
fixpoint_pass(const int32_t* __restrict__ ro, Fields<Op::NRW> fl, int h,
              int w, int32_t* __restrict__ changed) {
    constexpr bool kInShared = Op::RO != Ro::kAllow;
    // out-of-image fill of a shared ro plane: no label, no parent.
    constexpr int32_t kRoFill = Op::RO == Ro::kLabel ? -1 : 8;
    __shared__ uint32_t f[Op::NRW][NPIX];
    __shared__ int32_t lab[kInShared ? NPIX : 1];
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
            if constexpr (kInShared) lab[i] = inside ? ro[g] : kRoFill;
            else if (inside) bits[j] = static_cast<uint32_t>(ro[g]) & 0xffu;
        }
    }
    __syncthreads();

    // Direction bits, once per pass: the neighbour lies in the slab and in
    // the image (and, for label planes, has the same label; for parent
    // directions, is a child: its pdir is d's reverse (d + 4) % 8).
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
                if constexpr (Op::RO == Ro::kLabel)
                    ok = ok && lab[ny * SLAB + nx] == lab[i];
                else if constexpr (Op::RO == Ro::kPdir)
                    ok = ok && lab[ny * SLAB + nx] == ((d + 4) & 7);
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
            Op::init(nv[j], f, i);
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

int gseg_labeldist_pass(const void* allow, const void* L_in,
                        const void* idf_in, const void* dist_in, void* L_out,
                        void* idf_out, void* dist_out, int h, int w,
                        void* changed, void* stream) {
    Fields<3> fl{{static_cast<const uint32_t*>(L_in),
                  static_cast<const uint32_t*>(idf_in),
                  static_cast<const uint32_t*>(dist_in)},
                 {static_cast<uint32_t*>(L_out), static_cast<uint32_t*>(idf_out),
                  static_cast<uint32_t*>(dist_out)}};
    return launch<LabelDistOp>(allow, fl, h, w, changed, stream);
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

int gseg_subsum_pass(const void* pdir, const void* s_in, void* s_out, int h,
                     int w, void* changed, void* stream) {
    Fields<1> fl{{static_cast<const uint32_t*>(s_in)},
                 {static_cast<uint32_t*>(s_out)}};
    return launch<SubsumOp>(pdir, fl, h, w, changed, stream);
}

}  // extern "C"
