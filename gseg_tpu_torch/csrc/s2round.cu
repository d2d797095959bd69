// One compact round of stage 2 (models/turbo.py:_s2_round), for Hopper
// (sm_90a).
//
// Replaces the PyTorch ops of `turbo._s2_round_ops` (a lexsort of the
// pool by (source, w, edge id), a stable compaction of the run heads,
// pointer doubling over the heads) on a CUDA state; it has no TPU row:
// the reference runs the round as XLA ops too.
//
// What it computes. The state has n label slots (the root list's length in
// root space, V when V-indexed) and a pool of e directed entries (esrc,
// edst, ew, eeid). An entry is live when esrc != edst, ew is finite and,
// in a weight-capped round, ew <= tau. Each slot with a live entry is a
// head; its edge is its least live entry by (ew, eeid), ties to the lowest
// pool position (the stable sort's order). Heads are ranked in slot order
// (label order); those of rank >= head_cap are dropped and raise
// FLAG_COMP_OVERFLOW. A head hooks along its edge when the felz predicate
// (hw - IDf) * SZf <= k holds at both ends (float32, no contraction), or,
// in a min-size round, when its size is below min_size. Of a mutual pair
// the smaller label stays. Every head then takes the sink of its hook
// chain (a target that is not a head ends the chain), and, when
// canonical, each cluster the smallest head in it. Sizes add up and Int
// rises (IDf of the merged heads, weights of the used hooks) at the new
// roots; the pool and fin are relabelled; merged says whether any head
// moved. The result is byte-equal to `_s2_round_ops`.
//
// Design. One C entry queues all of it on the caller's stream (no host
// read, no allocation), over slot arrays in one scratch block
// (`ops/kernels/s2round.py:scratch_bytes`):
//   - s2_minedge: a 64-bit atomicMin of (bits(ew) << 32 | eeid ^ 2^31)
//     into best[src] (non-negative floats order like their bits; the xor
//     keeps int32 order). A warp first takes the minimum of each run of
//     equal sources in its lanes (the pool is mostly sorted by source), so
//     one atomic goes out a run.
//   - s2_minpos: the lowest position among entries equal to best[src].
//   - s2_count, s2_scan, s2_heads: heads counted in blocks of 1024 slots,
//     the block counts scanned by one block (and the overflow flag), then
//     each head's rank, its edge's target and the predicate: hook[x] (the
//     target, x itself, or -1 for no head).
//   - s2_mutual: mutual pairs broken; next[x] the hook target where that
//     is a head, else x.
//   - s2_jump: each launch follows up to 32 hops of the last launch's
//     pointers, so L launches reach next^(32^L); L is the least with
//     32^L >= 2^max(bitlen(min(head_cap, n)) + 1, 4), which covers the
//     fixed step count of the ops' pointer doubling. Chains are acyclic
//     (mutual pairs broken; (w, eeid) orders distinct edges strictly), so
//     both give the sink.
//   - s2_canon (canonical): atomicMin of each head into its sink's slot.
//   - s2_apply: M[x], the new label; atomicAdd of sizes, atomicMax of Int
//     on its bits (Int and weights are non-negative), the merged byte.
//   - s2_relabel: esrc, edst and fin through M.
// Every reduction is a min, a max or an integer sum, so the result does
// not depend on the order of the atomics. No kernel writes a slot that it
// or another thread of it reads, except an output that is its own input
// (in place), read and written by one thread:
// s2_apply reads SZf and IDf only at heads that move and writes them only
// at heads that stay.
//
// Bound on the H100: a few passes over the pool (12 bytes an entry read
// twice, 8 written) and about ten over the slots (4-8 bytes each),
// memory-bound; at root space's tens of thousands of slots the launches
// themselves (about 14) set the time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK = 1024;           // slots a block of the head ranks
constexpr int WARPS = BLOCK / 32;
constexpr int HOPS = 32;              // hops a jump launch follows
constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t INT32_MAX_ = 0x7fffffff;
constexpr unsigned long long NONE = ~0ull;
constexpr int32_t FLAG_COMP_OVERFLOW = 4;

__device__ __forceinline__ bool entry(int i, const int32_t* __restrict__ esrc,
                                      const int32_t* __restrict__ edst,
                                      const float* __restrict__ ew,
                                      const int32_t* __restrict__ eeid,
                                      const float* __restrict__ tau,
                                      int& src,
                                      unsigned long long& key) {
    src = esrc[i];
    const float w = ew[i];
    if (src == edst[i] || !isfinite(w) || (tau != nullptr && !(w <= *tau)))
        return false;
    key = (static_cast<unsigned long long>(__float_as_uint(w)) << 32)
          | (static_cast<uint32_t>(eeid[i]) ^ 0x80000000u);
    return true;
}

__global__ void s2_init(unsigned long long* __restrict__ best,
                        int32_t* __restrict__ bpos,
                        int32_t* __restrict__ canon, int n,
                        uint8_t* __restrict__ merged) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x == 0) *merged = 0;
    if (x >= n) return;
    best[x] = NONE;
    bpos[x] = INT32_MAX_;
    canon[x] = INT32_MAX_;
}

__global__ void __launch_bounds__(THREADS)
s2_minedge(const int32_t* __restrict__ esrc, const int32_t* __restrict__ edst,
           const float* __restrict__ ew, const int32_t* __restrict__ eeid,
           int e, const float* __restrict__ tau,
           unsigned long long* __restrict__ best) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int src = -1;
    unsigned long long key = NONE;
    if (i >= e || !entry(i, esrc, edst, ew, eeid, tau, src, key)) src = -1;
    // inclusive min-scan over each run of equal sources in the warp
    const int prev = __shfl_up_sync(FULL, src, 1);
    const unsigned starts = __ballot_sync(FULL, lane == 0 || prev != src);
    const int seg = 31 - __clz(starts & (FULL >> (31 - lane)));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long other = __shfl_up_sync(FULL, key, o);
        if (lane - o >= seg) key = min(key, other);
    }
    const int next = __shfl_down_sync(FULL, src, 1);
    if (src >= 0 && (lane == 31 || next != src)) atomicMin(best + src, key);
}

__global__ void s2_minpos(const int32_t* __restrict__ esrc,
                          const int32_t* __restrict__ edst,
                          const float* __restrict__ ew,
                          const int32_t* __restrict__ eeid, int e,
                          const float* __restrict__ tau,
                          const unsigned long long* __restrict__ best,
                          int32_t* __restrict__ bpos) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    int src;
    unsigned long long key;
    if (i < e && entry(i, esrc, edst, ew, eeid, tau, src, key)
            && key == best[src])
        atomicMin(bpos + src, i);
}

__global__ void __launch_bounds__(BLOCK)
s2_count(const unsigned long long* __restrict__ best, int n,
         int32_t* __restrict__ counts) {
    const int x = blockIdx.x * BLOCK + threadIdx.x;
    const int c = __syncthreads_count(x < n && best[x] != NONE);
    if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// one block: the exclusive scan of the block counts, and the flags
__global__ void __launch_bounds__(BLOCK)
s2_scan(const int32_t* __restrict__ counts, int nblk, int head_cap,
        const int32_t* flags_in, int32_t* __restrict__ offsets,
        int32_t* flags) {
    __shared__ int s_warp[WARPS];
    const int per = (nblk + BLOCK - 1) / BLOCK;
    const int j0 = threadIdx.x * per;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int sum = 0;
    for (int j = j0; j < j0 + per && j < nblk; ++j) sum += counts[j];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int p = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += p;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int base = incl - sum, total = 0;
    for (int k = 0; k < WARPS; ++k) {
        if (k < warp) base += s_warp[k];
        total += s_warp[k];
    }
    for (int j = j0; j < j0 + per && j < nblk; ++j) {
        offsets[j] = base;
        base += counts[j];
    }
    if (threadIdx.x == 0)
        *flags = *flags_in | (total > head_cap ? FLAG_COMP_OVERFLOW : 0);
}

__global__ void __launch_bounds__(BLOCK)
s2_heads(const unsigned long long* __restrict__ best,
         const int32_t* __restrict__ bpos,
         const int32_t* __restrict__ edst,
         const int32_t* __restrict__ szf, const float* __restrict__ idf,
         const int32_t* __restrict__ offsets, int n, int head_cap,
         int is_felz, float k, int min_size, int32_t* __restrict__ hook) {
    __shared__ int s_warp[WARPS];
    const int x = blockIdx.x * BLOCK + threadIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool head = x < n && best[x] != NONE;
    const unsigned b = __ballot_sync(FULL, head);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    if (x >= n) return;
    int rank = offsets[blockIdx.x] + __popc(b & ((1u << lane) - 1));
    for (int k = 0; k < warp; ++k) rank += s_warp[k];
    if (!head || rank >= head_cap) {
        hook[x] = -1;
        return;
    }
    const unsigned long long bx = best[x];
    const float hw = __uint_as_float(static_cast<uint32_t>(bx >> 32));
    const int dst = edst[bpos[x]];
    bool ok;
    if (is_felz) {
        const float ls = __fmul_rn(__fsub_rn(hw, idf[x]),
                                   __int2float_rn(szf[x]));
        const float ld = __fmul_rn(__fsub_rn(hw, idf[dst]),
                                   __int2float_rn(szf[dst]));
        ok = ls <= k && ld <= k;
    } else {
        ok = szf[x] < min_size;
    }
    hook[x] = ok ? dst : x;
}

__global__ void s2_mutual(const int32_t* __restrict__ hook, int n,
                          int32_t* __restrict__ succ,
                          int32_t* __restrict__ next) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x >= n) return;
    const int y = hook[x];
    if (y < 0) {
        next[x] = -1;
        return;
    }
    const int s = y != x && x < y && hook[y] == x ? x : y;
    succ[x] = s;
    next[x] = s != x && hook[s] >= 0 ? s : x;
}

__global__ void s2_jump(const int32_t* __restrict__ p_in, int n,
                        int32_t* __restrict__ p_out) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x >= n) return;
    int y = p_in[x];
    if (y >= 0) {
        for (int h = 1; h < HOPS; ++h) {
            const int z = p_in[y];
            if (z == y) break;
            y = z;
        }
    }
    p_out[x] = y;
}

__global__ void s2_canon(const int32_t* __restrict__ sink, int n,
                         int32_t* __restrict__ canon) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x < n && sink[x] >= 0) atomicMin(canon + sink[x], x);
}

__global__ void s2_apply(const int32_t* __restrict__ sink,
                         const int32_t* __restrict__ canon,
                         const int32_t* __restrict__ succ,
                         const unsigned long long* __restrict__ best,
                         const int32_t* szf_in, const float* idf_in, int n,
                         int canonical, int32_t* szf, float* idf,
                         int32_t* __restrict__ M,
                         uint8_t* __restrict__ merged) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x >= n) return;
    const int s = sink[x];
    if (s < 0) {
        M[x] = x;
        return;
    }
    const int r = canonical ? canon[s] : s;
    M[x] = r;
    int* idf_bits = reinterpret_cast<int*>(idf);
    if (r != x) {
        atomicAdd(szf + r, szf_in[x]);
        atomicMax(idf_bits + r, __float_as_int(idf_in[x]));
        *merged = 1;
    }
    if (succ[x] != x)
        atomicMax(idf_bits + r, static_cast<int>(best[x] >> 32));
}

__global__ void s2_relabel(const int32_t* __restrict__ M,
                           const int32_t* esrc_in, const int32_t* edst_in,
                           int e, const int32_t* fin_in, int c,
                           int32_t* esrc, int32_t* edst, int32_t* fin) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < e) {
        esrc[i] = M[esrc_in[i]];
        edst[i] = M[edst_in[i]];
    }
    if (i < c) fin[i] = M[fin_in[i]];
}

inline unsigned grid(int n, int threads) {
    return static_cast<unsigned>(n > 0 ? (n + threads - 1) / threads : 1);
}

}  // namespace

// All pointers are device pointers. Inputs: the pool (e entries), SZf and
// IDf (n slots), fin (c), the flags word; outputs: the pool's labels, SZf,
// IDf, fin, flags and the merged byte, each either a buffer of its own or
// its input (in place). k: the felz threshold; tau: the weight cap, null
// for none. scratch: 32 n + 8 ceil(n / 1024) bytes, 8-byte aligned.
extern "C" int gseg_s2_round(
    const int32_t* esrc_in, const int32_t* edst_in, const float* ew,
    const int32_t* eeid, int e, const int32_t* szf_in, const float* idf_in,
    int n, const int32_t* fin_in, int c, const int32_t* flags_in,
    int32_t* esrc, int32_t* edst, int32_t* szf, float* idf, int32_t* fin,
    uint8_t* merged, int32_t* flags, float k, const float* tau,
    int is_felz, int min_size, int canonical, int head_cap, void* scratch,
    cudaStream_t stream) {
    const int nblk = (n + BLOCK - 1) / BLOCK;
    auto* best = static_cast<unsigned long long*>(scratch);
    auto* bpos = reinterpret_cast<int32_t*>(best + n);
    int32_t* hook = bpos + n;
    int32_t* succ = hook + n;
    int32_t* pa = succ + n;
    int32_t* pb = pa + n;
    int32_t* canon = pb + n;
    int32_t* counts = canon + n;
    int32_t* offsets = counts + nblk;
    int32_t* M = bpos;  // bpos is dead once the heads are known
    if (szf != szf_in)
        cudaMemcpyAsync(szf, szf_in, sizeof(int32_t) * n,
                        cudaMemcpyDeviceToDevice, stream);
    if (idf != idf_in)
        cudaMemcpyAsync(idf, idf_in, sizeof(float) * n,
                        cudaMemcpyDeviceToDevice, stream);
    s2_init<<<grid(n, THREADS), THREADS, 0, stream>>>(best, bpos, canon, n,
                                                      merged);
    if (e > 0) {
        s2_minedge<<<grid(e, THREADS), THREADS, 0, stream>>>(
            esrc_in, edst_in, ew, eeid, e, tau, best);
        s2_minpos<<<grid(e, THREADS), THREADS, 0, stream>>>(
            esrc_in, edst_in, ew, eeid, e, tau, best, bpos);
    }
    s2_count<<<nblk, BLOCK, 0, stream>>>(best, n, counts);
    s2_scan<<<1, BLOCK, 0, stream>>>(counts, nblk, head_cap, flags_in,
                                     offsets, flags);
    s2_heads<<<nblk, BLOCK, 0, stream>>>(best, bpos, edst_in, szf_in, idf_in,
                                         offsets, n, head_cap, is_felz, k,
                                         min_size, hook);
    s2_mutual<<<grid(n, THREADS), THREADS, 0, stream>>>(hook, n, succ, pa);
    // steps of the ops' pointer doubling, then the jump launches
    const int bound = head_cap < n ? head_cap : n;
    int bits = 0;
    while (bits < 31 && (1 << bits) <= bound) ++bits;
    const int steps = bits + 1 > 4 ? bits + 1 : 4;
    for (int l = 0; l < (steps + 4) / 5; ++l) {
        s2_jump<<<grid(n, THREADS), THREADS, 0, stream>>>(pa, n, pb);
        int32_t* t = pa;
        pa = pb;
        pb = t;
    }
    if (canonical)
        s2_canon<<<grid(n, THREADS), THREADS, 0, stream>>>(pa, n, canon);
    s2_apply<<<grid(n, THREADS), THREADS, 0, stream>>>(
        pa, canon, succ, best, szf_in, idf_in, n, canonical, szf, idf, M,
        merged);
    const int m = e > c ? e : c;
    s2_relabel<<<grid(m, THREADS), THREADS, 0, stream>>>(
        M, esrc_in, edst_in, e, fin_in, c, esrc, edst, fin);
    return static_cast<int>(cudaGetLastError());
}
