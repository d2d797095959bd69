// Boundary-edge extraction for the turbo handoff, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/extract.py:_extract_kernel (called through
// boundary_extract). It turns the 4 canonical weight planes of the
// implicit grid graph into a compact pool of live boundary edges:
//   - the edge (d, y, x) from anchor a = (y, x) to b = (y+dy, x+dx) is
//     live when b lies in the image, its weight is finite and
//     L[a] != L[b]; it carries lo = min(L[a], L[b]), hi = max(...),
//     w and eid = (y*W + x)*4 + d;
//   - a run is a maximal sequence of consecutive live edges of one plane,
//     within one image row, that share (lo, hi); each run collapses to
//     one entry carrying its exact lexmin (w, eid), which is lossless for
//     the per-pair dedup downstream (only a pair's min edge can matter).
// Entries fill slots [0, count) in no particular order (the consumer sorts
// the pool, and every sort key includes the unique eid); slots past them
// hold lo = hi = eid = INT32_MAX and w = +inf; count is exact, and the
// overflow word is 1 iff count > cap (entries past cap are dropped).
//
// Design. One C entry, two launches. extract_fill writes the sentinels into
// every slot and zeroes the count and overflow words. extract_rows then
// takes one image row per block of 256 threads and walks it in tiles of
// 2048 pixels, 8 consecutive pixels per thread, one plane after another:
//   - the block stages rows y and y+1 of L over the tile (and two pixels on
//     each side) in shared memory with coalesced loads, once for all
//     planes; each thread loads a plane's 10 weights (its 8, 16-byte loads
//     where rows are aligned, and one on each side) while the previous
//     plane runs;
//   - a thread evaluates its 8 edges and its neighbours' nearest ones, so
//     it knows without any exchange whether a run goes on into its first
//     edge and out of its last;
//   - the tails are counted with a warp scan, and after one barrier the
//     block claims its tile's slots of the plane with one atomicAdd, whose
//     result is read only after the scan below; the block whose range ends
//     past cap sets the overflow word;
//   - a run's lexmin (w, eid) is a segmented min-scan along the row over
//     64-bit keys (order-preserving float bits, then eid): each thread
//     scans its 8 edges, a warp scan and, after a second barrier, the
//     warps' totals give each thread its carry-in, and the previous tile's
//     end value carries on, so a run that crosses threads, warps or tiles
//     gives one entry, at its tail, with its exact lexmin.
// No thread divides: the row is blockIdx.x and x a loop index.
//
// Bound on the H100: one read of L and the 4 weight planes (20 B per
// pixel, 41 MB at 1080p) and one write of the entries (16 B each),
// memory-bound; the sentinel fill writes the rest of the pool. The kernel
// reads L twice (rows y and y+1 come again as the next block's y+1 and y,
// mostly from L2).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int K = 8;                  // consecutive pixels per thread
constexpr int TILE = THREADS * K;     // pixels of a row per step
constexpr int SPAN = TILE + 4;        // staged: two before, two past
constexpr int STAGE = (SPAN + THREADS - 1) / THREADS;  // words per thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t INT32_MAX_ = 0x7fffffff;
constexpr uint64_t NONE = ~0ull;      // the scan's identity

// A (w, eid) key whose unsigned order is the lexicographic order: the
// float's bits made order-preserving, then the eid (>= 0).
__device__ __forceinline__ uint64_t key_of(float w, int eid) {
    uint32_t u = __float_as_uint(w);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(eid);
}

__device__ __forceinline__ float key_w(uint64_t k) {
    uint32_t u = static_cast<uint32_t>(k >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    return __uint_as_float(u);
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
    return a < b ? a : b;
}

__device__ __forceinline__ uint64_t shfl_up64(uint64_t v, int d) {
    const uint32_t lo = __shfl_up_sync(FULL, static_cast<uint32_t>(v), d);
    const uint32_t hi = __shfl_up_sync(FULL, static_cast<uint32_t>(v >> 32), d);
    return (static_cast<uint64_t>(hi) << 32) | lo;
}

// values at x + i, i < K, of a row (fill past w or before 0); 16-byte
// loads when `vec` (the caller's alignment test) and the 8 lie in the row.
template <class T>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int x,
                                         int w, bool vec, T fill, T* out) {
    if (vec && x >= 0 && x + K <= w) {
        const int4 p = *reinterpret_cast<const int4*>(row + x);
        const int4 q = *reinterpret_cast<const int4*>(row + x + 4);
        const int v[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < K; ++i) {
            T t;
            memcpy(&t, &v[i], 4);
            out[i] = t;
        }
    } else {
#pragma unroll
        for (int i = 0; i < K; ++i)
            out[i] = (x + i >= 0 && x + i < w) ? row[x + i] : fill;
    }
}

// Whether edge (d, y, xi) has both ends in the image. DIRS4: E (0, 1),
// S (1, 0), SE (1, 1), NE (1, -1).
__device__ __forceinline__ bool in_image(int d, int y, int xi, int h, int w) {
    if (xi < 0 || xi >= w) return false;
    if (d == 0) return xi + 1 < w;
    if (y + 1 >= h) return false;
    return d == 1 || (d == 2 ? xi + 1 < w : xi >= 1);
}

// Word i of a staged row span, one gap word after every 8: a thread's
// K = 8 consecutive words then sit 9 words from its neighbour's, so a
// warp reading word j of each thread's run hits 32 banks.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 3); }

__global__ void extract_fill(int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                             float* __restrict__ wv,
                             int32_t* __restrict__ eid, int cap,
                             int32_t* __restrict__ count_ovf) {
    const int stride = gridDim.x * blockDim.x;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cap; i += stride) {
        lo[i] = INT32_MAX_;
        hi[i] = INT32_MAX_;
        wv[i] = INFINITY;
        eid[i] = INT32_MAX_;
    }
    if (blockIdx.x == 0 && threadIdx.x < 2) count_ovf[threadIdx.x] = 0;
}

// At most 64 registers a thread: 4 blocks per SM (1080 rows in about two
// waves at 1080p).
__global__ void __launch_bounds__(THREADS, 4)
extract_rows(const int32_t* __restrict__ L, const float* __restrict__ weights,
             int h, int w, int cap, bool vec, int32_t* __restrict__ lo_out,
             int32_t* __restrict__ hi_out, float* __restrict__ w_out,
             int32_t* __restrict__ eid_out, int32_t* __restrict__ count,
             int32_t* __restrict__ overflow) {
    // rows y and y+1 of L over [x0 - 2, x0 + TILE + 2): span word i holds
    // x0 - 2 + i
    __shared__ int s_a[padded(SPAN) + 1], s_b[padded(SPAN) + 1];
    __shared__ int s_n[WARPS];         // entries of each warp
    __shared__ uint64_t s_key[WARPS];  // each warp's inclusive scan
    __shared__ bool s_flag[WARPS];     // ... and whether a run starts in it
    __shared__ uint64_t c_key[2][4];   // per plane, the scan at the end of
                                       // the previous tile (by tile parity)
    __shared__ int s_base;
    const int y = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t v = static_cast<size_t>(h) * w;
    const int32_t* row0 = L + static_cast<size_t>(y) * w;
    const int32_t* row1 = row0 + w;
    const float* wrow = weights + static_cast<size_t>(y) * w;
    const int base = K * static_cast<int>(threadIdx.x) + 2;  // x in the span
    if (threadIdx.x < 4) c_key[0][threadIdx.x] = NONE;
    for (int x0 = 0, par = 0; x0 < w; x0 += TILE, par ^= 1) {
        const int x = x0 + base - 2;
        // stage the span: every load issued before the first store
        int ra[STAGE], rb[STAGE];
#pragma unroll
        for (int j = 0; j < STAGE; ++j) {
            const int i = static_cast<int>(threadIdx.x) + j * THREADS;
            const int xi = x0 - 2 + i;
            const bool in = i < SPAN && xi >= 0 && xi < w;
            ra[j] = in ? row0[xi] : 0;
            rb[j] = in && y + 1 < h ? row1[xi] : 0;
        }
        // plane 0's weights at x - 1 .. x + K; each plane fetches the next
        // one's while it runs
        float wt[K + 2], wn[K + 2];
        auto load_w = [&](const float* plane, float (&out)[K + 2]) {
            load_run(plane, x, w, vec, static_cast<float>(INFINITY), out + 1);
            out[0] = x >= 1 && x - 1 < w ? plane[x - 1] : INFINITY;
            out[K + 1] = x + K < w ? plane[x + K] : INFINITY;
        };
        load_w(wrow, wt);
        __syncthreads();  // the previous tile's reads of the span are done
#pragma unroll
        for (int j = 0; j < STAGE; ++j) {
            const int i = static_cast<int>(threadIdx.x) + j * THREADS;
            if (i < SPAN) {
                s_a[padded(i)] = ra[j];
                s_b[padded(i)] = rb[j];
            }
        }
        __syncthreads();
        // edge j stands for the edge at x - 1 + j, j <= K + 1 (the last edge
        // of the previous thread, this thread's K, the next thread's first);
        // na[j] = L[y][x - 1 + j], its anchor's label
        int na[K + 2];
#pragma unroll
        for (int j = 0; j < K + 2; ++j) na[j] = s_a[padded(base - 1 + j)];
#pragma unroll 1
        for (int d = 0; d < 4; ++d) {
            if (d < 3) load_w(wrow + (d + 1) * v, wn);
            // fa[j]: the label at the far end of edge j: L[y][. + 1] (E),
            // L[y + 1][. + {0, 1, -1}] (S, SE, NE)
            const int* span = d == 0 ? s_a : s_b;
            const int off = base - 1 + (d == 0 || d == 2 ? 1 : d == 1 ? 0 : -1);
            int fa[K + 2];
#pragma unroll
            for (int j = 0; j < K + 2; ++j) fa[j] = span[padded(off + j)];
            unsigned live = 0;  // bit j: edge j is live
#pragma unroll
            for (int j = 0; j < K + 2; ++j)
                if (in_image(d, y, x - 1 + j, h, w) && na[j] != fa[j] &&
                    isfinite(wt[j]))
                    live |= 1u << j;
            // bit j: edge j continues edge j - 1 (same (lo, hi), both live)
            unsigned joins = 0;
#pragma unroll
            for (int j = 1; j < K + 2; ++j)
                if (((live >> j) & (live >> (j - 1)) & 1u) &&
                    min(na[j], fa[j]) == min(na[j - 1], fa[j - 1]) &&
                    max(na[j], fa[j]) == max(na[j - 1], fa[j - 1]))
                    joins |= 1u << j;
            // over this thread's edges i = j - 1 < K: cont, a run going on
            // from edge i - 1; tail, a run ending at edge i
            const unsigned mask = (1u << K) - 1;
            const unsigned cont = (joins >> 1) & mask;
            const unsigned tail = (live >> 1) & ~(joins >> 2) & mask;
            const int cnt = __popc(tail);
            int incl = cnt;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int q = __shfl_up_sync(FULL, incl, o);
                if (lane >= o) incl += q;
            }
            if (lane == 31) s_n[warp] = incl;
            __syncthreads();

            // claim the block's slots; the atomic's result is read only
            // after the scan below
            int total = 0, first = 0;
            if (threadIdx.x == 0) {
                for (int k = 0; k < WARPS; ++k) total += s_n[k];
                if (total > 0) first = atomicAdd(count, total);
            }
            int slot = incl - cnt;
            for (int k = 0; k < warp; ++k) slot += s_n[k];
            const size_t eid0 = (static_cast<size_t>(y) * w + x) * 4 + d;
            auto key = [&](int i) {  // of edge i = j - 1; NONE if dead
                return ((live >> (i + 1)) & 1u)
                           ? key_of(wt[i + 1], static_cast<int>(eid0 + 4 * i))
                           : NONE;
            };
            // this thread's scan, then the warp's over the threads
            uint64_t sc = NONE;
            bool open = true;  // no run starts in this thread's edges
#pragma unroll
            for (int i = 0; i < K; ++i) {
                if ((cont >> i) & 1u) {
                    sc = kmin(sc, key(i));
                } else {
                    sc = key(i);
                    open = false;
                }
            }
            bool f = !open;
            uint64_t sv = sc;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const uint64_t pv = shfl_up64(sv, o);
                const bool pf = __shfl_up_sync(FULL, f, o);
                if (lane >= o) {
                    if (!f) sv = kmin(sv, pv);
                    f = f || pf;
                }
            }
            uint64_t ev = shfl_up64(sv, 1);  // the lanes before this one
            bool ef = __shfl_up_sync(FULL, f, 1);
            if (lane == 0) {
                ev = NONE;
                ef = false;
            }
            if (lane == 31) {
                s_key[warp] = sv;
                s_flag[warp] = f;
            }
            if (threadIdx.x == 0) {
                s_base = first;
                if (first + total > cap) *overflow = 1;
            }
            __syncthreads();

            // the carry into this thread: the previous tile's end, the
            // earlier warps, the earlier lanes
            uint64_t c = c_key[par][d];
            for (int k = 0; k < warp; ++k)
                c = s_flag[k] ? s_key[k] : kmin(c, s_key[k]);
            c = ef ? ev : kmin(c, ev);
            if (threadIdx.x == THREADS - 1)
                c_key[par ^ 1][d] = open ? kmin(c, sc) : sc;
            slot += s_base;
            uint64_t r = NONE;
            bool reach = true;  // the carry reaches edge i
#pragma unroll
            for (int i = 0; i < K; ++i) {
                if ((cont >> i) & 1u) {
                    r = kmin(r, key(i));
                } else {
                    r = key(i);
                    reach = false;
                }
                if ((tail >> i) & 1u) {
                    const uint64_t m = reach ? kmin(c, r) : r;
                    if (slot < cap) {
                        lo_out[slot] = min(na[i + 1], fa[i + 1]);
                        hi_out[slot] = max(na[i + 1], fa[i + 1]);
                        w_out[slot] = key_w(m);
                        eid_out[slot] = static_cast<int32_t>(m & 0xffffffffu);
                    }
                    ++slot;
                }
            }
#pragma unroll
            for (int j = 0; j < K + 2; ++j) wt[j] = wn[j];
        }
    }
}

}  // namespace

// count_ovf: two int32 words, the exact entry count and the overflow flag.
extern "C" int gseg_boundary_extract(const void* L, const void* weights,
                                     int h, int w, int cap, void* lo,
                                     void* hi, void* wout, void* eid,
                                     void* count_ovf, void* stream) {
    if (h <= 0 || w <= 0 || cap < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    auto* co = static_cast<int32_t*>(count_ovf);
    const int fill_blocks =
        std::max(1, std::min((cap + THREADS - 1) / THREADS, 1024));
    extract_fill<<<fill_blocks, THREADS, 0, s>>>(
        static_cast<int32_t*>(lo), static_cast<int32_t*>(hi),
        static_cast<float*>(wout), static_cast<int32_t*>(eid), cap, co);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = w % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(weights) % 16 == 0;
    extract_rows<<<h, THREADS, 0, s>>>(
        static_cast<const int32_t*>(L), static_cast<const float*>(weights), h,
        w, cap, vec, static_cast<int32_t*>(lo), static_cast<int32_t*>(hi),
        static_cast<float*>(wout), static_cast<int32_t*>(eid), co, co + 1);
    return static_cast<int>(cudaGetLastError());
}
