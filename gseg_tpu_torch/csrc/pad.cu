// Padding and unpadding of the step fixpoints' fields, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/gossip.py:_fast_pad_fields and
// _fast_unpad_fields, which the reference's _step_fixpoint runs at entry
// and exit for images at least 2560 wide.
//
// What it computes:
//   pad:   up to 4 (h, w) planes of 32-bit words -> (hpad, wp) planes, the
//          data block at rows [t, t + h), columns [0, w), and each field's
//          own fill word everywhere else;
//   unpad: rows [t, t + h), columns [0, w) of up to 4 (hpad, wp) planes,
//          cut back to (h, w).
// The Pallas versions are HBM->HBM DMAs whose row offsets and widths must
// follow the TPU's (8, 128) tiling (t % 8, h % 8, w == wp); these kernels
// take any h, w, t and wp.
//
// Bound on the H100: pure copies. Each output word is written once and each
// input word read once (pad: 4 B read per data pixel and 4 B written per
// padded pixel, per field), so the bound is bytes over the HBM rate. The
// design: one launch for all fields (grid z = field); consecutive threads
// on consecutive columns, so every warp reads and writes 128 contiguous
// bytes; each block strides over rows (ROW_BLOCKS rows of blocks), so a
// 4K launch has ~7.7k blocks of ~17 rows each rather than ~130k blocks of
// one row. Vector (16-byte) accesses are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAXF = 4;
constexpr int THREADS = 256;
constexpr int ROW_BLOCKS = 128;  // grid rows; each block strides over rows

struct PadArgs {
    const uint32_t* in[MAXF];
    uint32_t* out[MAXF];
    uint32_t fill[MAXF];
};

__global__ void __launch_bounds__(THREADS)
pad_fields(PadArgs a, int h, int w, int t, int hpad, int wp) {
    const int k = blockIdx.z;
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x >= wp) return;
    for (int y = blockIdx.y; y < hpad; y += gridDim.y) {  // output rows
        const int sy = y - t;
        const bool data = sy >= 0 && sy < h && x < w;
        a.out[k][static_cast<size_t>(y) * wp + x] =
            data ? a.in[k][static_cast<size_t>(sy) * w + x] : a.fill[k];
    }
}

__global__ void __launch_bounds__(THREADS)
unpad_fields(PadArgs a, int h, int w, int t, int wp) {
    const int k = blockIdx.z;
    const int x = blockIdx.x * THREADS + threadIdx.x;
    if (x >= w) return;
    for (int y = blockIdx.y; y < h; y += gridDim.y)  // output rows
        a.out[k][static_cast<size_t>(y) * w + x] =
            a.in[k][static_cast<size_t>(y + t) * wp + x];
}

PadArgs args(int k, const void* const* in, void* const* out,
             const uint32_t* fill) {
    PadArgs a{};
    for (int j = 0; j < k; ++j) {
        a.in[j] = static_cast<const uint32_t*>(in[j]);
        a.out[j] = static_cast<uint32_t*>(out[j]);
        a.fill[j] = fill ? fill[j] : 0u;
    }
    return a;
}

}  // namespace

extern "C" {

// k fields (1..4): in[j] is (h, w), out[j] is (hpad, wp), fill[j] the
// 32-bit word written outside the data block. Requires hpad >= t + h and
// wp >= w.
int gseg_pad_fields(int k, const void* const* in, void* const* out,
                    const uint32_t* fill, int h, int w, int t, int hpad,
                    int wp, void* stream) {
    if (k < 1 || k > MAXF || t < 0 || hpad < t + h || wp < w)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((wp + THREADS - 1) / THREADS,
                    hpad < ROW_BLOCKS ? hpad : ROW_BLOCKS, k);
    pad_fields<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        args(k, in, out, fill), h, w, t, hpad, wp);
    return static_cast<int>(cudaGetLastError());
}

// k fields (1..4): in[j] is (hpad, wp), out[j] is (h, w), taken from rows
// [t, t + h) and columns [0, w).
int gseg_unpad_fields(int k, const void* const* in, void* const* out, int h,
                      int w, int t, int hpad, int wp, void* stream) {
    if (k < 1 || k > MAXF || t < 0 || hpad < t + h || wp < w)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((w + THREADS - 1) / THREADS,
                    h < ROW_BLOCKS ? h : ROW_BLOCKS, k);
    unpad_fields<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        args(k, in, out, nullptr), h, w, t, wp);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
