// Segmented interval closures of the quality-mode fixpoints, for Hopper
// (sm_90a).
//
// Replaces the closure half of gseg_tpu/ops/pallas/gossip.py:_strip_call
// (closure_fn: _compmin_closure, _labelnd_closure, _value_closure over
// _closure_4dir and _seg_closure), which _hybrid_fixpoint runs in its phase
// 2, past WARM_PASSES step passes, in row orientation and in the transposed
// layout.
//
// What it computes. One launch runs a bidirectional segmented closure along
// every full row (rows launch) or every full column (columns launch), in
// place:
//   - forward: each pixel joins every earlier pixel of its maximal run of
//     forward reach links (rows: flow from the left, allow bit 4; columns:
//     flow from above, bit 5);
//   - backward, on the forward results: each pixel joins every later pixel
//     of its run of backward reach links (rows: flow from the right, bit 0;
//     columns: flow from below, bit 1).
// compmin and value take their reach from the label plane (same label as
// the neighbour, both ways); labelnd from the packed allow bits, which may
// be asymmetric, hence the two bits. The columns launch is the reference's
// transposed pass done in place: _TRANSPOSE_PERM maps the transposed
// layout's L/R bits to the original U/D bits, so no transposed copies are
// made. The joins are the step variants' (csrc/gossip.cu): compmin lexmin
// of (bw, be) and, separately, max of sz; labelnd min of Lc and max of idf;
// value min of val. Each is a semilattice join, so the result at a pixel is
// the join over its directed reach interval whatever the order of
// evaluation: a sequential scan, a chunked one and the reference's
// log-step doubling give the same bits. Reach at the ends of a row or
// column is 0 (explicit bounds). The launch ORs a device flag when any
// field changed.
//
// Design. Rows: one block per row. The row's fields and its two reach bits
// sit in dynamic shared memory (13 B per pixel for compmin: 25 KB at
// w = 1920, 50 KB at 3840, so the limit is raised past 48 KB at launch).
// Each scan direction is a three-phase segmented scan: every thread scans
// a contiguous chunk sequentially, a Hillis-Steele scan over the threads'
// (value, chunk passes its carry) pairs gives each chunk its carry-in, and
// each thread folds that carry into the prefix of its chunk that the carry
// reaches. Columns: one thread per column (warp-wide blocks), a sequential
// down sweep and then an up sweep in registers, so neighbouring threads
// read neighbouring addresses.
//
// Bound on the H100: one launch reads the read-only plane and every field
// once and writes the fields once (28 B per pixel for compmin, 20 labelnd,
// 12 value: 58 / 41 / 25 MB at 1080p), a few compares per pixel: bytes-
// bound at ~17 / 12 / 7 us. The columns launch is latency-bound instead: a
// 1080-long dependent chain per thread on 1920 threads, one warp per SM
// slot. Making either fast (column tiles with a carry scan, vector loads)
// is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_THREADS = 32;
// DIRS8 bits of the reach links (gseg_tpu/ops/pallas/gossip.py:86-91).
constexpr int BIT_L = 4, BIT_R = 0, BIT_U = 5, BIT_D = 1;

enum class Ro { kLabel, kAllow };

// Each Op: NRW read-write 32-bit fields, the kind of read-only plane and
// join (fold n into c).
struct CompminOp {  // fields: bw (f32 bits), be (i32), sz (i32)
    static constexpr int NRW = 3;
    static constexpr Ro RO = Ro::kLabel;
    __device__ static void join(uint32_t (&c)[NRW], const uint32_t (&n)[NRW]) {
        const float cw = __uint_as_float(c[0]);
        const float nw = __uint_as_float(n[0]);
        if (nw < cw || (nw == cw && static_cast<int>(n[1]) <
                                        static_cast<int>(c[1]))) {
            c[0] = n[0];
            c[1] = n[1];
        }
        if (static_cast<int>(n[2]) > static_cast<int>(c[2])) c[2] = n[2];
    }
};

struct LabelndOp {  // fields: Lc (i32), idf (f32 bits)
    static constexpr int NRW = 2;
    static constexpr Ro RO = Ro::kAllow;
    __device__ static void join(uint32_t (&c)[NRW], const uint32_t (&n)[NRW]) {
        if (static_cast<int>(n[0]) < static_cast<int>(c[0])) c[0] = n[0];
        if (__uint_as_float(n[1]) > __uint_as_float(c[1])) c[1] = n[1];
    }
};

struct ValueOp {  // field: val (i32)
    static constexpr int NRW = 1;
    static constexpr Ro RO = Ro::kLabel;
    __device__ static void join(uint32_t (&c)[NRW], const uint32_t (&n)[NRW]) {
        if (static_cast<int>(n[0]) < static_cast<int>(c[0])) c[0] = n[0];
    }
};

template <int N>
struct Io {
    uint32_t* f[N];  // (h, w) planes, updated in place
};

// Row reach bits of pixel x of a row (bit 0: the value flows in from x - 1,
// bit 1: from x + 1).
template <class Op>
__device__ __forceinline__ uint8_t row_reach(const int32_t* __restrict__ r,
                                             int x, int w) {
    uint8_t out = 0;
    if constexpr (Op::RO == Ro::kLabel) {
        const int l = r[x];
        if (x > 0 && r[x - 1] == l) out |= 1;
        if (x + 1 < w && r[x + 1] == l) out |= 2;
    } else {
        const uint32_t b = static_cast<uint32_t>(r[x]);
        if (x > 0 && ((b >> BIT_L) & 1u)) out |= 1;
        if (x + 1 < w && ((b >> BIT_R) & 1u)) out |= 2;
    }
    return out;
}

// One direction of the row closure over the shared row (n pixels). Logical
// index i runs along the scan: pixel x = i forward, n - 1 - i backward; the
// reach bit `bit` of pixel x says its value takes its predecessor's.
template <class Op>
__device__ void row_scan(uint32_t* const* f, const uint8_t* reach, int n,
                         bool fwd,
                         uint32_t (*agg)[ROW_THREADS], uint8_t* pass) {
    constexpr int N = Op::NRW;
    const int tid = threadIdx.x;
    const uint8_t bit = fwd ? 1 : 2;
    const int chunk = (n + ROW_THREADS - 1) / ROW_THREADS;
    const int lo = min(tid * chunk, n);
    const int hi = min(lo + chunk, n);

    // 1. sequential scan of the chunk; `all`: every pixel of the chunk takes
    //    its predecessor's value, so a carry from before the chunk reaches
    //    its last pixel.
    uint32_t c[N];
    bool all = true;
    for (int i = lo; i < hi; ++i) {
        const int x = fwd ? i : n - 1 - i;
        uint32_t v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = f[k][x];
        const bool takes = reach[x] & bit;
        if (i > lo && takes) {
            Op::join(v, c);
#pragma unroll
            for (int k = 0; k < N; ++k) f[k][x] = v[k];
        }
        all = all && takes;
#pragma unroll
        for (int k = 0; k < N; ++k) c[k] = v[k];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) agg[k][tid] = lo < hi ? c[k] : 0u;
    pass[tid] = lo < hi && all;
    __syncthreads();

    // 2. inclusive Hillis-Steele scan over the chunks: (a, pa) then (m, pm)
    //    gives (pm ? join(a, m) : m, pa && pm).
    for (int s = 1; s < ROW_THREADS; s <<= 1) {
        uint32_t a[N], m[N];
        bool pa = false, pm = false;
        if (tid >= s) {
#pragma unroll
            for (int k = 0; k < N; ++k) {
                a[k] = agg[k][tid - s];
                m[k] = agg[k][tid];
            }
            pa = pass[tid - s];
            pm = pass[tid];
        }
        __syncthreads();
        if (tid >= s) {
            if (pm) Op::join(m, a);
#pragma unroll
            for (int k = 0; k < N; ++k) agg[k][tid] = m[k];
            pass[tid] = pa && pm;
        }
        __syncthreads();
    }

    // 3. the carry-in (the scan up to the previous chunk's end) reaches the
    //    chunk's prefix up to the first pixel that takes nothing.
    if (tid > 0 && lo < hi) {
        uint32_t cin[N];
#pragma unroll
        for (int k = 0; k < N; ++k) cin[k] = agg[k][tid - 1];
        for (int i = lo; i < hi; ++i) {
            const int x = fwd ? i : n - 1 - i;
            if (!(reach[x] & bit)) break;
            uint32_t v[N];
#pragma unroll
            for (int k = 0; k < N; ++k) v[k] = f[k][x];
            Op::join(v, cin);
#pragma unroll
            for (int k = 0; k < N; ++k) f[k][x] = v[k];
        }
    }
    __syncthreads();
}

template <class Op>
__global__ void __launch_bounds__(ROW_THREADS)
closure_rows(const int32_t* __restrict__ ro, Io<Op::NRW> io, int w,
             int32_t* __restrict__ changed) {
    constexpr int N = Op::NRW;
    extern __shared__ uint32_t smem[];
    __shared__ uint32_t agg[N][ROW_THREADS];
    __shared__ uint8_t pass[ROW_THREADS];
    __shared__ int block_changed;

    uint32_t* f[N];
#pragma unroll
    for (int k = 0; k < N; ++k) f[k] = smem + static_cast<size_t>(k) * w;
    uint8_t* reach = reinterpret_cast<uint8_t*>(smem + static_cast<size_t>(N) * w);
    const size_t row = static_cast<size_t>(blockIdx.x) * w;
    if (threadIdx.x == 0) block_changed = 0;
    for (int x = threadIdx.x; x < w; x += ROW_THREADS) {
#pragma unroll
        for (int k = 0; k < N; ++k) f[k][x] = io.f[k][row + x];
        reach[x] = row_reach<Op>(ro + row, x, w);
    }
    __syncthreads();

    row_scan<Op>(f, reach, w, true, agg, pass);
    row_scan<Op>(f, reach, w, false, agg, pass);

    bool any = false;
    for (int x = threadIdx.x; x < w; x += ROW_THREADS) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
            const uint32_t v = f[k][x];
            if (v != io.f[k][row + x]) {
                io.f[k][row + x] = v;
                any = true;
            }
        }
    }
    if (any) block_changed = 1;
    __syncthreads();
    if (threadIdx.x == 0 && block_changed) atomicOr(changed, 1);
}

// Whether pixel g takes the value of its column neighbour gn (the row above
// on the down sweep, the row below on the up sweep).
template <class Op>
__device__ __forceinline__ bool col_takes(const int32_t* __restrict__ ro,
                                          size_t g, size_t gn, int bit) {
    if constexpr (Op::RO == Ro::kLabel) return ro[g] == ro[gn];
    else return (static_cast<uint32_t>(ro[g]) >> bit) & 1u;
}

template <class Op>
__global__ void __launch_bounds__(COL_THREADS)
closure_cols(const int32_t* __restrict__ ro, Io<Op::NRW> io, int h, int w,
             int32_t* __restrict__ changed) {
    constexpr int N = Op::NRW;
    const int x = blockIdx.x * COL_THREADS + threadIdx.x;
    if (x >= w) return;
    bool any = false;
    uint32_t c[N];
    // down sweep: flow from above.
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = io.f[k][x];
#pragma unroll 4
    for (int y = 1; y < h; ++y) {
        const size_t g = static_cast<size_t>(y) * w + x;
        uint32_t v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = io.f[k][g];
        if (col_takes<Op>(ro, g, g - w, BIT_U)) {
            uint32_t o[N];
#pragma unroll
            for (int k = 0; k < N; ++k) o[k] = v[k];
            Op::join(v, c);
#pragma unroll
            for (int k = 0; k < N; ++k) {
                if (v[k] != o[k]) {
                    io.f[k][g] = v[k];
                    any = true;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < N; ++k) c[k] = v[k];
    }
    // up sweep, on the down sweep's results: flow from below.
    const size_t last = static_cast<size_t>(h - 1) * w + x;
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = io.f[k][last];
#pragma unroll 4
    for (int y = h - 2; y >= 0; --y) {
        const size_t g = static_cast<size_t>(y) * w + x;
        uint32_t v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = io.f[k][g];
        if (col_takes<Op>(ro, g, g + w, BIT_D)) {
            uint32_t o[N];
#pragma unroll
            for (int k = 0; k < N; ++k) o[k] = v[k];
            Op::join(v, c);
#pragma unroll
            for (int k = 0; k < N; ++k) {
                if (v[k] != o[k]) {
                    io.f[k][g] = v[k];
                    any = true;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < N; ++k) c[k] = v[k];
    }
    if (__any_sync(__activemask(), any) && (threadIdx.x & 31) == 0)
        atomicOr(changed, 1);
}

// Dynamic shared memory a rows launch needs at width w.
template <class Op>
size_t row_smem(int w) {
    return static_cast<size_t>(w) * (4 * Op::NRW + 1);
}

template <class Op>
int launch(const void* ro, Io<Op::NRW> io, int h, int w, int axis,
           void* changed, void* stream) {
    if (h <= 0 || w <= 0 || (axis != 0 && axis != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* r = static_cast<const int32_t*>(ro);
    auto* ch = static_cast<int32_t*>(changed);
    if (axis == 1) {
        const size_t smem = row_smem<Op>(w);
        cudaError_t err = cudaFuncSetAttribute(
            closure_rows<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        closure_rows<Op><<<h, ROW_THREADS, smem, s>>>(r, io, w, ch);
    } else {
        closure_cols<Op><<<(w + COL_THREADS - 1) / COL_THREADS, COL_THREADS,
                           0, s>>>(r, io, h, w, ch);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The widest row a rows launch takes for a variant with nrw fields: the
// dynamic shared memory limit of a block less the static part.
int gseg_closure_max_width(int nrw) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    const int static_bytes = (4 * nrw + 1) * ROW_THREADS + 16;
    return (optin - static_bytes) / (4 * nrw + 1);
}

// axis 1: every row (along w); axis 0: every column (along h).
int gseg_compmin_closure(const void* L, void* bw, void* be, void* sz, int h,
                         int w, int axis, void* changed, void* stream) {
    Io<3> io{{static_cast<uint32_t*>(bw), static_cast<uint32_t*>(be),
              static_cast<uint32_t*>(sz)}};
    return launch<CompminOp>(L, io, h, w, axis, changed, stream);
}

int gseg_labelnd_closure(const void* allow, void* Lc, void* idf, int h, int w,
                         int axis, void* changed, void* stream) {
    Io<2> io{{static_cast<uint32_t*>(Lc), static_cast<uint32_t*>(idf)}};
    return launch<LabelndOp>(allow, io, h, w, axis, changed, stream);
}

int gseg_value_closure(const void* L, void* val, int h, int w, int axis,
                       void* changed, void* stream) {
    Io<1> io{{static_cast<uint32_t*>(val)}};
    return launch<ValueOp>(L, io, h, w, axis, changed, stream);
}

}  // extern "C"
