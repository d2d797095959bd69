// The join of the chunk fronts of the chunked pair dedup
// (models/turbo.py:_chunked_pair_extract), for Hopper (sm_90a).
//
// Replaces the output-space scan of the PyTorch ops that joined them (a
// scatter of each chunk's offset, an int64 `torch.cummax` over the whole
// output, an offset permutation of the sort's indices and four gathers);
// it has no TPU row: the reference joins them with XLA ops
// (gseg_tpu/models/turbo.py:1249, `_chunked_pair_extract`).
//
// What it computes. The dedup sorts n = nch * chunk slots in nch chunks of
// `chunk` and moves each chunk's pair heads, counts[c] of them, to the
// chunk's front: perm[c, i] is the position within chunk c of its i-th
// slot after the sorts. The join lays the fronts one after another into
// pair_cap output slots. With offsets the exclusive prefix sum of counts,
// total their sum and cl[c] = min(offsets[c], pair_cap - 1), output slot j
// takes
//   chunk_of = (number of c with cl[c] <= j) - 1
//   src      = clamp(chunk_of * chunk + j - offsets[chunk_of], 0, n - 1)
//   g        = (src / chunk) * chunk + perm[src]
//   out      = (j < total, lo[g], hi[g], w[g], eid[g])
// and overflow = total > pair_cap. That is the ops' result byte for byte in
// every slot, the masked slots and the overflow case included (a slot past
// total reads some slot of the last chunk that reaches it, or a clamped
// one). lo, hi, w and eid are moved as 4-byte words.
//
// Design. One launch over the output slots, 2048 a block. Each block
// first scans counts into its shared memory (offsets as int32: n < 2^31;
// nch <= MAX_CHUNKS, 32 KB) and total, with a warp-shuffle block scan;
// then each thread takes 8 slots (stride 256, so a warp's stores are
// coalesced), finds its chunk by binary search over the clamped offsets
// in shared memory, reads its perm entry and gathers the four words. No
// atomics, no scratch, no host read; block 0 writes the overflow byte.
//
// Bound on the H100: memory. A slot writes 17 bytes (mask and four words)
// and reads an 8-byte perm entry and four 4-byte words; the perm reads are
// sequential within a chunk, the gathers land within one chunk's 512 KB of
// each array (the sort's order), mostly in L2. Each block re-reads counts
// (8 B a chunk) from L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                    // output slots a thread
constexpr int SLOTS = THREADS * ITEMS;      // output slots a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNKS = 8192;            // ops/kernels/pairjoin.py
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
pair_join(const int64_t* __restrict__ counts,
          const int64_t* __restrict__ perm,
          const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
          const uint32_t* __restrict__ w, const uint32_t* __restrict__ eid,
          int nch, int chunk, int pair_cap, uint8_t* __restrict__ mask,
          uint32_t* __restrict__ olo, uint32_t* __restrict__ ohi,
          uint32_t* __restrict__ ow, uint32_t* __restrict__ oeid,
          uint8_t* __restrict__ overflow) {
  extern __shared__ int32_t off[];          // offsets, nch entries
  __shared__ long long warp_sum[WARPS];
  __shared__ long long total_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the block scan: thread t sums its run of `per` consecutive counts
  const int per = (nch + THREADS - 1) / THREADS;
  const int c0 = min(t * per, nch), c1 = min(c0 + per, nch);
  long long own = 0;
  for (int c = c0; c < c1; ++c) own += counts[c];
  long long incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (t == 0) {
    long long run = 0;
    for (int k = 0; k < WARPS; ++k) {
      const long long s = warp_sum[k];
      warp_sum[k] = run;
      run += s;
    }
    total_s = run;
  }
  __syncthreads();
  long long excl = warp_sum[warp] + incl - own;
  for (int c = c0; c < c1; ++c) {
    off[c] = int32_t(excl);
    excl += counts[c];
  }
  __syncthreads();
  const long long total = total_s;
  if (blockIdx.x == 0 && t == 0) overflow[0] = total > pair_cap;
  const int cap1 = pair_cap - 1;
  const long long last = (long long)nch * chunk - 1;
  const long long base = (long long)blockIdx.x * SLOTS + t;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long jl = base + (long long)k * THREADS;
    if (jl >= pair_cap) break;
    const int j = int(jl);
    int a = 0, b = nch;                     // chunks with cl <= j: [0, a)
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (min(off[mid], cap1) <= j) a = mid + 1;
      else b = mid;
    }
    const int c = a - 1;                    // cl[0] = 0 <= j: c >= 0
    long long src = (long long)c * chunk + j - off[c];
    src = src < 0 ? 0 : (src > last ? last : src);
    const long long g = src / chunk * chunk + perm[src];
    mask[j] = j < total;
    olo[j] = lo[g];
    ohi[j] = hi[g];
    ow[j] = w[g];
    oeid[j] = eid[g];
  }
}

}  // namespace

extern "C" int gseg_pair_join(const void* counts, const void* perm,
                              const void* lo, const void* hi, const void* w,
                              const void* eid, int nch, int chunk,
                              int pair_cap, void* mask, void* olo, void* ohi,
                              void* ow, void* oeid, void* overflow,
                              void* stream) {
  if (nch < 1 || nch > MAX_CHUNKS || chunk < 1 || pair_cap < 1
      || (long long)nch * chunk > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const long long grid = ((long long)pair_cap + SLOTS - 1) / SLOTS;
  pair_join<<<unsigned(grid), THREADS, sizeof(int32_t) * nch,
              cudaStream_t(stream)>>>(
      static_cast<const int64_t*>(counts), static_cast<const int64_t*>(perm),
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(w), static_cast<const uint32_t*>(eid), nch,
      chunk, pair_cap, static_cast<uint8_t*>(mask),
      static_cast<uint32_t*>(olo), static_cast<uint32_t*>(ohi),
      static_cast<uint32_t*>(ow), static_cast<uint32_t*>(oeid),
      static_cast<uint8_t*>(overflow));
  return int(cudaGetLastError());
}
