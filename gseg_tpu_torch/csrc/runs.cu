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
// Pairs fill slots [0, count) in no particular order (the consumer sorts
// them by label) and are written only below the capacity; slots past them
// hold label INT32_MAX and length 0; count is exact (the Pallas kernel's is
// an upper bound at window granularity), and the overflow word is 1 iff
// count > cap.
//
// Design. One C entry: a 4-byte memset of the count word, then two
// launches.
//   - runs_rows takes one image row per block of 256 threads and walks it
//     in tiles of 2048 pixels, 8 consecutive pixels per thread, read with
//     two 16-byte loads where rows are aligned (and the pixels just before
//     and after, from L1). A thread flags its heads (label differs from
//     the left neighbour) and tails (differs from the right one).
//   - A run's head is the last head at or before its tail, so its length
//     comes from a max-scan of head positions along the row (the TPU
//     kernel's reach/hp loop, extract.py:223-233): each thread's last
//     head, a warp max-scan by shuffles, the warps' maxima in shared
//     memory, and the previous tiles' last head carried in a register.
//     No thread walks a run.
//   - The tails are counted with a warp sum-scan; after one barrier a
//     thread claims the tile's slots with one atomicAdd for the block; the
//     pairs are staged in shared memory in row order and, after a second
//     barrier, written out by consecutive threads to consecutive slots
//     (coalesced), only below cap. Shared words of the scans alternate
//     between two sets by tile parity, so two barriers a tile suffice.
//   - runs_fill then reads the final count and writes the sentinels into
//     slots [count, cap) only, and the overflow word. It runs after
//     runs_rows on the same stream, so no slot is written twice.
//
// Bound on the H100: one read of L (4 B per pixel, 8.3 MB at 1080p) and
// 8 B per emitted pair, memory-bound; the sentinel fill writes 8 B per
// slot past the count on top of that.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int K = 8;                  // consecutive pixels per thread
constexpr int TILE = THREADS * K;     // pixels of a row per step
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t INT32_MAX_ = 0x7fffffff;

__global__ void __launch_bounds__(THREADS)
runs_rows(const int32_t* __restrict__ L, int w, int cap, bool vec,
          int32_t* __restrict__ lab_out, int32_t* __restrict__ cnt_out,
          int32_t* __restrict__ count) {
    __shared__ int s_head[2][WARPS];  // each warp's last head (-1: none)
    __shared__ int s_n[2][WARPS];     // each warp's tails
    __shared__ int s_base[2];         // the tile's first slot
    __shared__ int32_t s_lab[TILE], s_cnt[TILE];  // the tile's pairs
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int32_t* row = L + static_cast<size_t>(blockIdx.x) * w;
    int carry = 0;  // the last head of the previous tiles (x = 0 is one)
    for (int x0 = 0, par = 0; x0 < w; x0 += TILE, par ^= 1) {
        const int x = x0 + K * static_cast<int>(threadIdx.x);
        int v[K];
        if (vec && x + K <= w) {
            const int4 p = *reinterpret_cast<const int4*>(row + x);
            const int4 q = *reinterpret_cast<const int4*>(row + x + 4);
            v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
            v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
        } else {
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = x + i < w ? row[x + i] : 0;
        }
        const int left = x >= 1 && x - 1 < w ? row[x - 1] : 0;
        const int right = x + K < w ? row[x + K] : 0;
        // bit i: pixel x + i (in the row) starts / ends a run
        unsigned head = 0, tail = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
            if (x + i >= w) break;
            const int l = i == 0 ? left : v[i - 1];
            const int r = i == K - 1 ? right : v[i + 1];
            if (x + i == 0 || v[i] != l) head |= 1u << i;
            if (x + i + 1 == w || v[i] != r) tail |= 1u << i;
        }
        // inclusive warp scans: the last head (max), the tails (sum)
        int hp = head ? x + 31 - __clz(head) : -1;
        const int nt = __popc(tail);
        int incl = nt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int ph = __shfl_up_sync(FULL, hp, o);
            const int pn = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) {
                hp = max(hp, ph);
                incl += pn;
            }
        }
        int hp_before = __shfl_up_sync(FULL, hp, 1);  // the lanes before
        if (lane == 0) hp_before = -1;
        if (lane == 31) {
            s_head[par][warp] = hp;
            s_n[par][warp] = incl;
        }
        __syncthreads();

        int total = 0, off = incl - nt, tile_head = -1;
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
            const int n = s_n[par][k];
            total += n;
            if (k < warp) {
                off += n;
                hp_before = max(hp_before, s_head[par][k]);
            }
            tile_head = max(tile_head, s_head[par][k]);
        }
        if (threadIdx.x == 0)
            s_base[par] = total > 0 ? atomicAdd(count, total) : 0;
        // stage this thread's pairs in row order; run_head: the last head
        // at or before pixel x + i
        int run_head = max(carry, hp_before);
#pragma unroll
        for (int i = 0; i < K; ++i) {
            if ((head >> i) & 1u) run_head = x + i;
            if ((tail >> i) & 1u) {
                s_lab[off] = v[i];
                s_cnt[off] = x + i - run_head + 1;
                ++off;
            }
        }
        carry = max(carry, tile_head);
        __syncthreads();

        const int base = s_base[par];
        for (int j = threadIdx.x; j < total && base + j < cap; j += THREADS) {
            lab_out[base + j] = s_lab[j];
            cnt_out[base + j] = s_cnt[j];
        }
    }
}

__global__ void runs_fill(int32_t* __restrict__ lab, int32_t* __restrict__ cnt,
                          int cap, int32_t* __restrict__ count_ovf) {
    const int n = count_ovf[0];
    if (blockIdx.x == 0 && threadIdx.x == 0) count_ovf[1] = n > cap;
    const int stride = gridDim.x * blockDim.x;
    for (int i = n + blockIdx.x * blockDim.x + threadIdx.x; i < cap;
         i += stride) {
        lab[i] = INT32_MAX_;
        cnt[i] = 0;
    }
}

}  // namespace

// count_ovf: two int32 words, the exact pair count and the overflow flag.
extern "C" int gseg_run_extract(const void* L, int h, int w, int cap,
                                void* lab, void* cnt, void* count_ovf,
                                void* stream) {
    if (h <= 0 || w <= 0 || cap < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    auto* co = static_cast<int32_t*>(count_ovf);
    cudaError_t err = cudaMemsetAsync(co, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
    runs_rows<<<h, THREADS, 0, s>>>(
        static_cast<const int32_t*>(L), w, cap, vec,
        static_cast<int32_t*>(lab), static_cast<int32_t*>(cnt), co);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int fill_blocks =
        std::max(1, std::min((cap + THREADS - 1) / THREADS, 1024));
    runs_fill<<<fill_blocks, THREADS, 0, s>>>(
        static_cast<int32_t*>(lab), static_cast<int32_t*>(cnt), cap, co);
    return static_cast<int>(cudaGetLastError());
}
