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
//
// Design. One thread per edge slot. The thread at a run's tail (its right
// neighbour does not continue the run) walks left to the run's head and
// takes the lexmin, so the total work is O(live edges). The tail claims an
// output slot with an atomicAdd on a device counter and writes only if the
// slot is below the capacity; the counter ends at the exact entry count,
// and the caller flags overflow iff it exceeds the capacity. Output order
// is free: the consumer sorts the pool, and every sort key includes the
// unique eid. The Pallas kernel's in-VMEM stream compaction and sequential
// output offsets become that one atomic.
//
// Bound on the H100: one pass over L (read ~3x through L1/L2 for the
// neighbour and run-continuation tests) and the 4 weight planes, 40 MB at
// 1080p, plus one atomic per surviving run; memory-bound.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Edge {
    bool live;
    int lo, hi;
};

// DIRS4: E (0, 1), S (1, 0), SE (1, 1), NE (1, -1).
__device__ __forceinline__ Edge edge_at(const int32_t* __restrict__ L,
                                        const float* __restrict__ wd, int d,
                                        int y, int x, int h, int w) {
    const int ny = y + (d == 0 ? 0 : 1);
    const int nx = x + (d == 1 ? 0 : (d == 3 ? -1 : 1));
    Edge e{false, 0, 0};
    if (ny >= h || nx < 0 || nx >= w) return e;
    const size_t a = static_cast<size_t>(y) * w + x;
    if (!(wd[a] < INFINITY)) return e;
    const int la = L[a];
    const int lb = L[static_cast<size_t>(ny) * w + nx];
    if (la == lb) return e;
    e.live = true;
    e.lo = min(la, lb);
    e.hi = max(la, lb);
    return e;
}

__global__ void __launch_bounds__(THREADS)
boundary_extract_kernel(const int32_t* __restrict__ L,
                        const float* __restrict__ weights, int h, int w,
                        int cap, int32_t* __restrict__ lo_out,
                        int32_t* __restrict__ hi_out,
                        float* __restrict__ w_out,
                        int32_t* __restrict__ eid_out,
                        int32_t* __restrict__ count) {
    const long long v = static_cast<long long>(h) * w;
    const long long t =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= 4 * v) return;
    const int d = static_cast<int>(t / v);
    const int p = static_cast<int>(t % v);
    const int y = p / w, x = p % w;
    const float* wd = weights + static_cast<size_t>(d) * v;

    const Edge e = edge_at(L, wd, d, y, x, h, w);
    if (!e.live) return;
    if (x + 1 < w) {
        const Edge r = edge_at(L, wd, d, y, x + 1, h, w);
        if (r.live && r.lo == e.lo && r.hi == e.hi) return;  // not a tail
    }
    const size_t row = static_cast<size_t>(y) * w;
    float bw = wd[row + x];
    int be = (y * w + x) * 4 + d;
    for (int xx = x - 1; xx >= 0; --xx) {
        const Edge l = edge_at(L, wd, d, y, xx, h, w);
        if (!(l.live && l.lo == e.lo && l.hi == e.hi)) break;
        const float lw = wd[row + xx];
        const int le = (y * w + xx) * 4 + d;
        if (lw < bw || (lw == bw && le < be)) {
            bw = lw;
            be = le;
        }
    }
    const int slot = atomicAdd(count, 1);
    if (slot < cap) {
        lo_out[slot] = e.lo;
        hi_out[slot] = e.hi;
        w_out[slot] = bw;
        eid_out[slot] = be;
    }
}

}  // namespace

extern "C" int gseg_boundary_extract(const void* L, const void* weights,
                                     int h, int w, int cap, void* lo,
                                     void* hi, void* wout, void* eid,
                                     void* count, void* stream) {
    const long long n = 4LL * h * w;
    const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
    boundary_extract_kernel<<<blocks, THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(L), static_cast<const float*>(weights), h,
        w, cap, static_cast<int32_t*>(lo), static_cast<int32_t*>(hi),
        static_cast<float*>(wout), static_cast<int32_t*>(eid),
        static_cast<int32_t*>(count));
    return static_cast<int>(cudaGetLastError());
}
