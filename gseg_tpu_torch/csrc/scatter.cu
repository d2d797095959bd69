// Ordered scatter-add of float32 rows, for Hopper (sm_90a).
//
// A helper with no TPU kernel behind it. The superpixel path keeps each
// component's colour sum at its root slot and adds rows into it by
// scatter: the pixels' smoothed colours in round 1
// (gseg_tpu/models/superpixel.py:95-97) and the merged members' sums in
// every compact round (:209-211). XLA:CPU adds a scatter's updates one
// after another in update order; torch's CUDA `index_add_` /
// `scatter_reduce_` add them with atomics in whatever order they land,
// so float sums would differ from the reference in the last bits, and
// between two runs. The weights of the next round compare averages of
// these sums, so a last-bit difference can flip a near-tie merge.
//
// What it computes. out = base, then for every update i in increasing i
// whose target t = sidx-order slot lies in [0, slots): out[t] += vals[i],
// row by row (C <= 4 floats), each add rounded once (__fadd_rn).
//
// Design. The wrapper sorts the targets stably (torch.sort), so each
// target's updates form one run in index order, and copies base into out.
// One launch: one thread per sorted position; the thread at the head of a
// run walks the run and adds its rows in order in registers, then writes
// the target's row once. No atomics, so the result is the same on every
// run and equal to the plain version's.
//
// Bound on the H100: memory. The function reads the targets (4 B) and the
// rows (4C B) of every update and the base rows, and writes the out rows
// (the wrapper's copy); the kernel itself reads each update once, through
// the sort's permutation (a gather), and reads and writes each touched row
// once. A long run is walked by one thread, so the launch takes as long as
// the longest run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 4;

__global__ void __launch_bounds__(THREADS)
run_sums(const int32_t* __restrict__ sidx, const int64_t* __restrict__ order,
         const float* __restrict__ vals, float* __restrict__ out, int64_t n,
         int c, int32_t slots) {
  const int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int32_t t = sidx[i];
  if (t < 0 || t >= slots) return;          // a dropped update
  if (i > 0 && sidx[i - 1] == t) return;    // not the head of its run
  float acc[MAX_C];
#pragma unroll
  for (int k = 0; k < MAX_C; ++k)
    if (k < c) acc[k] = out[int64_t(t) * c + k];
  for (int64_t j = i; j < n && sidx[j] == t; ++j) {
    const float* row = vals + order[j] * c;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      if (k < c) acc[k] = __fadd_rn(acc[k], row[k]);
  }
#pragma unroll
  for (int k = 0; k < MAX_C; ++k)
    if (k < c) out[int64_t(t) * c + k] = acc[k];
}

}  // namespace

extern "C" int gseg_ordered_scatter_add(const void* sidx, const void* order,
                                        const void* vals, void* out,
                                        long long n, int c, int slots,
                                        void* stream) {
  if (c < 1 || c > MAX_C) return int(cudaErrorInvalidValue);
  if (n > 0) {
    const long long grid = (n + THREADS - 1) / THREADS;
    run_sums<<<unsigned(grid), THREADS, 0, cudaStream_t(stream)>>>(
        static_cast<const int32_t*>(sidx), static_cast<const int64_t*>(order),
        static_cast<const float*>(vals), static_cast<float*>(out), n, c,
        slots);
  }
  return int(cudaGetLastError());
}
