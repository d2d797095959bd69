// Padding and unpadding of the step fixpoints' fields, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/gossip.py:_fast_pad_fields (:703, call :781)
// and _fast_unpad_fields (:799, call :826), which the reference's
// _step_fixpoint runs at entry and exit for images at least 2560 wide.
//
// What it computes:
//   pad:   up to 4 (h, w) planes of 32-bit words -> (hpad, wp) planes, the
//          data block at rows [t, t + h), columns [0, w), and each field's
//          own fill word everywhere else;
//   unpad: rows [t, t + h), columns [0, w) of up to 4 (hpad, wp) planes,
//          cut back to (h, w).
// The Pallas versions are whole-block HBM->HBM DMAs whose row offsets and
// widths must follow the TPU's (8, 128) tiling (t % 8, h % 8, w == wp);
// these kernels take any h, w, t and wp.
//
// Bound on the H100: bytes. Each input word is read once and each output
// word written once (pad: 4 B read per data pixel and 4 B written per
// padded pixel, per field), so the least time is those bytes over the HBM
// rate. A copy does no arithmetic, so it reaches that rate only with
// enough bytes in flight: about 3.35 TB/s x ~600 ns = 2 MB across the
// card. One 4-byte load in flight per thread gives ~1.1 MB (132 SMs x
// 2048 threads), half the rate. Both routes below keep many more in
// flight. Alignment alone picks the route, inside the C entry:
//
//   bulk route (w and wp multiples of 4 words, every plane 16-byte
//   aligned: every 2560, 3840, 4096 and 7680-wide frame, since wp is a
//   multiple of 128): the counterpart of the TPU's DMAs, Hopper's bulk
//   asynchronous copies (TMA, cp.async.bulk) through shared memory. A work
//   unit is one (field, data row, <= 16 KB chunk). A persistent grid of 2
//   blocks per SM walks the units; in each block one thread keeps a ring of
//   STAGES shared-memory stages busy: it starts the global->shared copy of
//   a unit (completion on the stage's mbarrier), waits for it, starts the
//   shared->global copy of the stage (a bulk group), and refills the stage
//   of the previous unit once that unit's store has read it. So STAGES - 1
//   loads of up to 16 KB and a store are in flight per block, ~12 MB
//   across the card, from one instruction each. In pad, the block's other
//   warps write the fill regions (rows [0, t), rows [t + h, hpad), columns
//   [w, wp)) with 16-byte stores meanwhile.
//
//   register route (any other shape: rows not 16-byte aligned, which bulk
//   copies require): each thread owns one column of a block of rows and
//   loads UNROLL rows' words before it stores any, so UNROLL independent
//   loads are in flight per thread; consecutive threads take consecutive
//   words (a warp reads and writes 128 contiguous bytes); the grid is a
//   few waves over the SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXF = 4;
constexpr int MAX_DEVICES = 64;

// bulk route
constexpr int CHUNK = 16384;                       // bytes per unit, at most
constexpr int STAGES = 4;                          // shared-memory ring
constexpr int BULK_SMEM = STAGES * CHUNK;          // dynamic shared memory
constexpr int BULK_BLOCKS_PER_SM = 2;
constexpr int PAD_BULK_THREADS = 128;              // warp 0 copies, 1-3 fill
constexpr int UNPAD_BULK_THREADS = 32;

// register route
constexpr int REG_THREADS = 256;
constexpr int UNROLL = 8;                          // loads in flight a thread
constexpr int REG_WAVES = 4;

struct Planes {
    const uint32_t* in[MAXF];
    uint32_t* out[MAXF];
    uint32_t fill[MAXF];
};

// arr[f] by unrolled selects: indexing the kernel's parameters with a
// runtime f would copy them to the stack.
template <class T>
__device__ __forceinline__ T pick(const T (&arr)[MAXF], int f) {
    T v = arr[0];
#pragma unroll
    for (int j = 1; j < MAXF; ++j)
        if (f == j) v = arr[j];
    return v;
}

// ---------------------------------------------------------------------------
// bulk asynchronous copies (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// global -> shared, completing `bytes` transactions on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}

// shared -> global, as one committed bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// all but the newest bulk group have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read_all_but_newest() {
    asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One unit: field f, data row r, chunk c of the row's w words.
struct Unit {
    const char* src;
    char* dst;
    uint32_t bytes;
};

template <bool PAD>
__device__ __forceinline__ Unit unit(const Planes& a, long long u, int h,
                                     int w, int t, int wp, int nchunk) {
    const long long per_field = static_cast<long long>(h) * nchunk;
    const int f = static_cast<int>(u / per_field);
    const long long rc = u - f * per_field;
    const long long r = rc / nchunk;
    const int c = static_cast<int>(rc - r * nchunk);
    const long long off = static_cast<long long>(c) * CHUNK;
    const long long row_bytes = 4LL * w;
    const long long src_row = PAD ? r * w : (r + t) * wp;
    const long long dst_row = PAD ? (r + t) * wp : r * w;
    Unit x;
    x.src = reinterpret_cast<const char*>(pick(a.in, f)) + 4 * src_row + off;
    x.dst = reinterpret_cast<char*>(pick(a.out, f)) + 4 * dst_row + off;
    x.bytes = static_cast<uint32_t>(
        row_bytes - off < CHUNK ? row_bytes - off : CHUNK);
    return x;
}

// The copy loop of one block, run by one thread: units blockIdx.x,
// blockIdx.x + gridDim.x, ... through a ring of STAGES stages.
template <bool PAD>
__device__ void bulk_copy_loop(const Planes& a, int k, int h, int w, int t,
                               int wp, unsigned char* stage,
                               uint64_t* full) {
    const int nchunk = (4 * w + CHUNK - 1) / CHUNK;
    const long long units = static_cast<long long>(k) * h * nchunk;
    if (units <= blockIdx.x) return;
    const long long n = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const uint32_t stage0 = smem_addr(stage);
    const uint32_t bar0 = smem_addr(full);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s);
    mbar_init_fence();
    auto load = [&](long long i) {
        const int s = static_cast<int>(i % STAGES);
        const Unit x = unit<PAD>(a, blockIdx.x + i * gridDim.x, h, w, t, wp,
                                 nchunk);
        bulk_load(stage0 + s * CHUNK, x.src, x.bytes, bar0 + 8 * s);
    };
    for (long long i = 0; i < STAGES && i < n; ++i) load(i);
    for (long long i = 0; i < n; ++i) {
        const int s = static_cast<int>(i % STAGES);
        mbar_wait(bar0 + 8 * s, static_cast<uint32_t>((i / STAGES) & 1));
        const Unit x = unit<PAD>(a, blockIdx.x + i * gridDim.x, h, w, t, wp,
                                 nchunk);
        bulk_store(x.dst, stage0 + s * CHUNK, x.bytes);
        // refill the previous unit's stage once its store has read it.
        if (i >= 1 && i - 1 + STAGES < n) {
            bulk_wait_read_all_but_newest();
            load(i - 1 + STAGES);
        }
    }
    bulk_wait_all();
}

// The fill regions of pad, 16-byte words: rows [0, t) and [t + h, hpad)
// whole, then columns [w, wp) of each data row; spread over the fill
// threads (warps 1.. of every block).
__device__ void bulk_fill(const Planes& a, int k, int h, int w, int t,
                          int hpad, int wp) {
    const long long wp4 = wp / 4;
    const long long top = t * wp4;
    const long long bottom = (hpad - t - h) * wp4;
    const long long side4 = (wp - w) / 4;
    const long long per_field = top + bottom + h * side4;
    const long long fillers = blockDim.x - 32;
    const long long stride = gridDim.x * fillers;
    for (long long i = blockIdx.x * fillers + threadIdx.x - 32;
         i < k * per_field; i += stride) {
        const int f = static_cast<int>(i / per_field);
        long long e = i - f * per_field;
        long long idx;
        if (e < top) {
            idx = e;
        } else if (e < top + bottom) {
            idx = (t + h) * wp4 + (e - top);
        } else {
            e -= top + bottom;
            const long long r = e / side4;
            idx = (r + t) * wp4 + w / 4 + (e - r * side4);
        }
        const uint32_t v = pick(a.fill, f);
        reinterpret_cast<uint4*>(pick(a.out, f))[idx] = make_uint4(v, v, v, v);
    }
}

__global__ void __launch_bounds__(PAD_BULK_THREADS)
pad_fields_bulk(const Planes a, int k, int h, int w, int t, int hpad,
                int wp) {
    extern __shared__ __align__(128) unsigned char stage[];
    __shared__ __align__(8) uint64_t full[STAGES];
    if (threadIdx.x == 0)
        bulk_copy_loop<true>(a, k, h, w, t, wp, stage, full);
    else if (threadIdx.x >= 32)
        bulk_fill(a, k, h, w, t, hpad, wp);
}

__global__ void __launch_bounds__(UNPAD_BULK_THREADS)
unpad_fields_bulk(const Planes a, int k, int h, int w, int t, int wp) {
    extern __shared__ __align__(128) unsigned char stage[];
    __shared__ __align__(8) uint64_t full[STAGES];
    if (threadIdx.x == 0)
        bulk_copy_loop<false>(a, k, h, w, t, wp, stage, full);
}

// ---------------------------------------------------------------------------
// register route
// ---------------------------------------------------------------------------

// Output rows [blockIdx.y * rows, + rows) of field blockIdx.z, one column a
// thread, UNROLL rows' loads made before their stores.
template <bool PAD>
__device__ __forceinline__ void regs_copy(const Planes& a, int h, int w,
                                          int t, int hpad, int wp,
                                          int rows) {
    const int f = blockIdx.z;
    const uint32_t* __restrict__ in = pick(a.in, f);
    uint32_t* __restrict__ out = pick(a.out, f);
    const uint32_t fill = pick(a.fill, f);
    const int ow = PAD ? wp : w;
    const int oh = PAD ? hpad : h;
    const int x = blockIdx.x * REG_THREADS + threadIdx.x;
    if (x >= ow) return;
    const int y0 = blockIdx.y * rows;
    const int y1 = y0 + rows < oh ? y0 + rows : oh;
    for (int y = y0; y < y1; y += UNROLL) {
        uint32_t v[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const int yy = y + j;
            if (PAD) {
                const int sy = yy - t;
                v[j] = yy < y1 && sy >= 0 && sy < h && x < w
                           ? in[static_cast<size_t>(sy) * w + x]
                           : fill;
            } else {
                v[j] = yy < y1 ? in[static_cast<size_t>(yy + t) * wp + x]
                               : 0u;
            }
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j)
            if (y + j < y1) out[static_cast<size_t>(y + j) * ow + x] = v[j];
    }
}

__global__ void __launch_bounds__(REG_THREADS)
pad_fields_regs(const Planes a, int h, int w, int t, int hpad, int wp,
                int rows) {
    regs_copy<true>(a, h, w, t, hpad, wp, rows);
}

__global__ void __launch_bounds__(REG_THREADS)
unpad_fields_regs(const Planes a, int h, int w, int t, int wp, int rows) {
    regs_copy<false>(a, h, w, t, 0, wp, rows);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

Planes planes(int k, const void* const* in, void* const* out,
              const uint32_t* fill) {
    Planes a{};
    for (int j = 0; j < k; ++j) {
        a.in[j] = static_cast<const uint32_t*>(in[j]);
        a.out[j] = static_cast<uint32_t*>(out[j]);
        a.fill[j] = fill ? fill[j] : 0u;
    }
    return a;
}

// Rows of 16-byte aligned 4-word groups in every plane: the bulk route.
bool aligned(int k, const void* const* in, void* const* out, int w, int wp) {
    if (w % 4 != 0 || wp % 4 != 0) return false;
    for (int j = 0; j < k; ++j)
        if (reinterpret_cast<uintptr_t>(in[j]) % 16 != 0 ||
            reinterpret_cast<uintptr_t>(out[j]) % 16 != 0)
            return false;
    return true;
}

// The current device's SM count; the bulk kernels' shared-memory limit is
// raised once per device.
cudaError_t device_setup(int* sms) {
    static int sm_count[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (sm_count[dev] == 0) {
        int n = 0;
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(pad_fields_bulk,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   BULK_SMEM);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(unpad_fields_bulk,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   BULK_SMEM);
        if (err != cudaSuccess) return err;
        sm_count[dev] = n;
    }
    *sms = sm_count[dev];
    return cudaSuccess;
}

// The register route's grid over an (oh, ow) output: column blocks, row
// blocks of `rows` rows (a multiple of UNROLL) so that the grid is about
// REG_WAVES waves, fields.
dim3 regs_grid(int k, int oh, int ow, int sms, int* rows) {
    const int cols = (ow + REG_THREADS - 1) / REG_THREADS;
    const int wave = sms * (2048 / REG_THREADS);
    int row_blocks = REG_WAVES * wave / (cols * k);
    if (row_blocks < 1) row_blocks = 1;
    int r = (oh + row_blocks - 1) / row_blocks;
    r = (r + UNROLL - 1) / UNROLL * UNROLL;
    *rows = r;
    return dim3(cols, (oh + r - 1) / r, k);
}

}  // namespace

extern "C" {

// k fields (1..4): in[j] is (h, w), out[j] is (hpad, wp), fill[j] the
// 32-bit word written outside the data block. Requires hpad >= t + h and
// wp >= w.
int gseg_pad_fields(int k, const void* const* in, void* const* out,
                    const uint32_t* fill, int h, int w, int t, int hpad,
                    int wp, void* stream) {
    if (k < 1 || k > MAXF || h < 0 || w < 0 || t < 0 || hpad < t + h ||
        wp < w)
        return static_cast<int>(cudaErrorInvalidValue);
    if (hpad == 0 || wp == 0) return static_cast<int>(cudaSuccess);
    int sms = 0;
    cudaError_t err = device_setup(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    const Planes a = planes(k, in, out, fill);
    if (aligned(k, in, out, w, wp)) {
        pad_fields_bulk<<<BULK_BLOCKS_PER_SM * sms, PAD_BULK_THREADS,
                          BULK_SMEM, s>>>(a, k, h, w, t, hpad, wp);
    } else {
        int rows = 0;
        const dim3 grid = regs_grid(k, hpad, wp, sms, &rows);
        pad_fields_regs<<<grid, REG_THREADS, 0, s>>>(a, h, w, t, hpad, wp,
                                                     rows);
    }
    return static_cast<int>(cudaGetLastError());
}

// k fields (1..4): in[j] is (hpad, wp), out[j] is (h, w), taken from rows
// [t, t + h) and columns [0, w).
int gseg_unpad_fields(int k, const void* const* in, void* const* out, int h,
                      int w, int t, int hpad, int wp, void* stream) {
    if (k < 1 || k > MAXF || h < 0 || w < 0 || t < 0 || hpad < t + h ||
        wp < w)
        return static_cast<int>(cudaErrorInvalidValue);
    if (h == 0 || w == 0) return static_cast<int>(cudaSuccess);
    int sms = 0;
    cudaError_t err = device_setup(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto s = static_cast<cudaStream_t>(stream);
    const Planes a = planes(k, in, out, nullptr);
    if (aligned(k, in, out, w, wp)) {
        unpad_fields_bulk<<<BULK_BLOCKS_PER_SM * sms, UNPAD_BULK_THREADS,
                            BULK_SMEM, s>>>(a, k, h, w, t, wp);
    } else {
        int rows = 0;
        const dim3 grid = regs_grid(k, h, w, sms, &rows);
        unpad_fields_regs<<<grid, REG_THREADS, 0, s>>>(a, h, w, t, wp, rows);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
