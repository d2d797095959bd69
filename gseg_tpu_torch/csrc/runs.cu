// Row-run extraction of a label plane, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/extract.py:_runs_kernel (called through
// run_extract), which the reference's `runs` peel (GSEG_PEEL_SIZES=runs)
// uses for exact component sizes: the maximal runs of equal labels along
// each row partition the plane, so their lengths summed by label are the
// component pixel counts.
//
// What it computes. Every maximal run of equal labels within one image row
// (runs never cross rows) emits one pair (label, length) at its tail, the
// pixel whose right neighbour has another label or lies outside the row.
// Pairs go to slots claimed with an atomicAdd on a device counter and are
// written only below the capacity; the counter ends at the exact pair
// count (the Pallas kernel's is an upper bound at window granularity), and
// the caller flags overflow iff it exceeds the capacity. Order is free:
// the consumer sorts the pairs by label.
//
// Design. One thread per pixel; a tail walks left to its run's head, so the
// total work is O(pixels) and each pixel is read by at most two threads
// (its own and its run's tail); the Pallas kernel's max-scan of head
// positions and in-VMEM stream compaction become that walk and one atomic.
//
// Bound on the H100: one read of L (4 B per pixel, 8.3 MB at 1080p) and
// 8 B per emitted pair; memory-bound (~2.5 us at 1080p plus the pairs).
// Long runs serialise their tail's walk (at most a row), and every pair
// costs one atomic on one counter; a warp-aggregated claim is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
run_extract_kernel(const int32_t* __restrict__ L, int h, int w, int cap,
                   int32_t* __restrict__ lab_out, int32_t* __restrict__ cnt_out,
                   int32_t* __restrict__ count) {
    const long long v = static_cast<long long>(h) * w;
    const long long p =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (p >= v) return;
    const int x = static_cast<int>(p % w);
    const int32_t l = L[p];
    if (x + 1 < w && L[p + 1] == l) return;  // not a tail
    int len = 1;
    while (x - len >= 0 && L[p - len] == l) ++len;
    const int slot = atomicAdd(count, 1);
    if (slot < cap) {
        lab_out[slot] = l;
        cnt_out[slot] = len;
    }
}

}  // namespace

extern "C" int gseg_run_extract(const void* L, int h, int w, int cap,
                                void* lab, void* cnt, void* count,
                                void* stream) {
    if (h <= 0 || w <= 0 || cap < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long n = static_cast<long long>(h) * w;
    const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
    run_extract_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(L), h, w, cap,
        static_cast<int32_t*>(lab), static_cast<int32_t*>(cnt),
        static_cast<int32_t*>(count));
    return static_cast<int>(cudaGetLastError());
}
