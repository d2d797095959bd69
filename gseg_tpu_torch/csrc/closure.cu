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
// Design. Both launches run a three-phase segmented scan per direction:
// every thread scans a contiguous chunk sequentially, a scan over the
// chunks' (value, chunk passes its carry) pairs gives each chunk its
// carry-in, and each thread folds that carry into the prefix of its chunk
// that the carry reaches. Rows: one block per row; the row's fields and its
// two reach bits sit in dynamic shared memory (13 B per pixel for compmin:
// 25 KB at w = 1920, 50 KB at 3840, so the limit is raised past 48 KB at
// launch), and the carry scan is a Hillis-Steele scan over the 256 chunks.
// Columns: a block of 256 threads takes COLS = 8 adjacent columns whole (240
// blocks at w = 1920, so every SM has work), R = 32 chunks of ceil(h / 32)
// rows per column, threads of a warp on adjacent columns of four rows, so
// a warp's loads and stores are 32-byte sectors; one thread per column runs
// the carry scan over its R chunks in shared memory; the up sweep follows
// the down sweep after a barrier and reads its results back through L2 (a
// 1080p plane set is 17-33 MB, the L2 50 MB). A column never spans two
// blocks, so no carry crosses blocks and each axis stays one launch. Only
// words that change are written back.
//
// Bound on the H100: one launch reads the read-only plane and every field
// once and writes the fields once (28 B per pixel for compmin, 20 labelnd,
// 12 value: 58 / 41 / 25 MB at 1080p), a few compares per pixel: bytes-
// bound at ~17 / 12 / 7 us per launch. A columns launch reads each field
// about twice (the two sweeps, the folds), mostly from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_THREADS = 256;
// Columns per block of the columns launch (see the note at the top).
constexpr int COLS = 8;
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

// Whether pixel y of column x takes the value of its column neighbour: the
// pixel above on the down sweep, the one below on the up sweep; none across
// the ends.
template <class Op>
__device__ __forceinline__ bool col_takes(const int32_t* __restrict__ ro,
                                          int y, int x, int h, int w,
                                          bool down) {
    const int yn = down ? y - 1 : y + 1;
    if (yn < 0 || yn >= h) return false;
    const int32_t r = ro[static_cast<size_t>(y) * w + x];
    if constexpr (Op::RO == Ro::kLabel)
        return r == ro[static_cast<size_t>(yn) * w + x];
    else
        return (static_cast<uint32_t>(r) >> (down ? BIT_U : BIT_D)) & 1u;
}

// One direction of the column closure over a block's COLS columns (see the
// note at the top). Thread (r, c) owns rows [lo, hi) of column x; s is its
// chunk's place in scan order (the down sweep runs the chunks top to
// bottom, the up sweep bottom to top). Returns whether it changed a word.
template <class Op>
__device__ bool col_scan(const int32_t* __restrict__ ro, Io<Op::NRW> io,
                         int x, int h, int w, int lo, int hi, int s, int c,
                         bool down,
                         uint32_t (*agg)[COL_THREADS / COLS][COLS],
                         uint8_t (*pass)[COLS]) {
    constexpr int N = Op::NRW;
    constexpr int R = COL_THREADS / COLS;
    const int n = hi - lo;
    bool any = false;

    // 1. sequential scan of the chunk; `all`: every pixel of it takes its
    //    predecessor's value, so a carry from before the chunk reaches its
    //    last pixel.
    uint32_t cur[N];
    bool all = true;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
        const int y = down ? lo + i : hi - 1 - i;
        const size_t g = static_cast<size_t>(y) * w + x;
        uint32_t v[N];
#pragma unroll
        for (int k = 0; k < N; ++k) v[k] = io.f[k][g];
        const bool takes = col_takes<Op>(ro, y, x, h, w, down);
        if (i > 0 && takes) {
            uint32_t o[N];
#pragma unroll
            for (int k = 0; k < N; ++k) o[k] = v[k];
            Op::join(v, cur);
#pragma unroll
            for (int k = 0; k < N; ++k) {
                if (v[k] != o[k]) {
                    io.f[k][g] = v[k];
                    any = true;
                }
            }
        }
        all = all && takes;
#pragma unroll
        for (int k = 0; k < N; ++k) cur[k] = v[k];
    }
#pragma unroll
    for (int k = 0; k < N; ++k) agg[k][s][c] = n > 0 ? cur[k] : 0u;
    pass[s][c] = n > 0 && all;
    __syncthreads();

    // 2. the carry scan: one thread per column runs over its R chunks in
    //    scan order, (a, pa) then (m, pm) giving (pm ? join(m, a) : m);
    //    agg[k][s] becomes the scan's value at the end of chunk s. Empty
    //    chunks come last in row order; a chunk after one in scan order
    //    starts at the image's end, so it never takes the carry.
    if (threadIdx.x < COLS) {
        for (int t = 1; t < R; ++t) {
            if (!pass[t][c]) continue;
            uint32_t m[N], a[N];
#pragma unroll
            for (int k = 0; k < N; ++k) {
                m[k] = agg[k][t][c];
                a[k] = agg[k][t - 1][c];
            }
            Op::join(m, a);
#pragma unroll
            for (int k = 0; k < N; ++k) agg[k][t][c] = m[k];
        }
    }
    __syncthreads();

    // 3. the carry-in (the scan's value at the previous chunk's end) reaches
    //    the chunk's prefix up to the first pixel that takes nothing.
    if (s > 0 && n > 0) {
        uint32_t cin[N];
#pragma unroll
        for (int k = 0; k < N; ++k) cin[k] = agg[k][s - 1][c];
        for (int i = 0; i < n; ++i) {
            const int y = down ? lo + i : hi - 1 - i;
            if (!col_takes<Op>(ro, y, x, h, w, down)) break;
            const size_t g = static_cast<size_t>(y) * w + x;
            uint32_t v[N], o[N];
#pragma unroll
            for (int k = 0; k < N; ++k) o[k] = v[k] = io.f[k][g];
            Op::join(v, cin);
#pragma unroll
            for (int k = 0; k < N; ++k) {
                if (v[k] != o[k]) {
                    io.f[k][g] = v[k];
                    any = true;
                }
            }
        }
    }
    __syncthreads();
    return any;
}

// Columns launch: a block takes COLS adjacent columns whole; thread (r, c)
// scans rows [r * chunk, (r + 1) * chunk) of column c, so a warp reads
// 32 / COLS rows of COLS adjacent words at each step.
template <class Op>
__global__ void __launch_bounds__(COL_THREADS)
closure_cols(const int32_t* __restrict__ ro, Io<Op::NRW> io, int h, int w,
             int32_t* __restrict__ changed) {
    constexpr int N = Op::NRW;
    constexpr int R = COL_THREADS / COLS;
    __shared__ uint32_t agg[N][R][COLS];
    __shared__ uint8_t pass[R][COLS];
    const int c = threadIdx.x % COLS, r = threadIdx.x / COLS;
    // columns past w take part in the barriers only, with empty chunks
    const int x = min(static_cast<int>(blockIdx.x) * COLS + c, w - 1);
    const bool col = static_cast<int>(blockIdx.x) * COLS + c < w;
    const int chunk = (h + R - 1) / R;
    const int lo = col ? min(r * chunk, h) : h;
    const int hi = col ? min(lo + chunk, h) : h;
    bool any = col_scan<Op>(ro, io, x, h, w, lo, hi, r, c, true, agg, pass);
    any |= col_scan<Op>(ro, io, x, h, w, lo, hi, R - 1 - r, c, false, agg,
                        pass);
    if (__syncthreads_or(any) && threadIdx.x == 0) atomicOr(changed, 1);
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
        const unsigned blocks = static_cast<unsigned>((w + COLS - 1) / COLS);
        closure_cols<Op><<<blocks, COL_THREADS, 0, s>>>(r, io, h, w, ch);
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
