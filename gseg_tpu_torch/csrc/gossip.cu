// One T-step pass of the turbo path's step fixpoints, for Hopper (sm_90a).
//
// Replaces gseg_tpu/ops/pallas/gossip.py:_strip_call_skip, as
// _step_fixpoint drives it, with the five step variants of the turbo path:
// compmin (_compmin_prepare + _compmin_step), the label flood with the BFS
// distance riding along (_allow_prepare + _label_step), the dist-free
// label flood (_allow_prepare + _labelnd_step), the value flood
// (_compmin_prepare + _value_step) and the subtree sums (_subsum_prepare +
// _subsum_step).
//
// What it computes. Four variants are semilattice joins over an
// 8-connected adjacency given per pixel as 8 direction bits (same label,
// or the packed allow bits of the floods):
//   compmin:   lexmin of (bw, be) and max of sz;
//   labeldist: lexmin of (Lc, dist), a neighbour offering (nL, nd + 1)
//              (nd + 1 saturating at BIG), and max of idf. This is the
//              reference's adopt (strictly smaller label) / relax (equal
//              label, smaller distance) chain written as one lexmin;
//   labelnd:   min of the label and max of idf;
//   value:     min of val.
// Their fixpoint is unique (per allow component: the min label, then the
// BFS distance from that label's seeds), and every step only lowers (lex)
// mins and raises maxes, so a pass that ends where it began changed
// nothing at any step: the host's exit on a pass with no change certifies
// the global one-step fixpoint, and a Jacobi pass reaches the same fixpoint
// as the reference's chained in-step updates.
//
// subsum is not a join: s <- 1 + sum of s over the children, where the
// children of p are the neighbours whose parent direction (pdir, 0-7;
// 8 = none) points at p. Each new value starts from 1 (Op::init), not from
// the old one. The map F(s) = 1 + A s is affine with A nilpotent (the
// parent tree is acyclic: a parent has dist one less), so its fixpoint s*
// is unique, and F^T(s) = s implies s = s*: with e = s - s*,
// F^T(s) - s* = A^T e, so e = A^T e = A^(nT) e = 0. Nilpotency, not
// monotonicity, makes the no-change exit a certificate here.
//
// The pass. A CUDA grid runs in no order, so each pass is Jacobi: it reads
// one copy of the fields and writes the other. A block owns a TILE x TILE
// interior, loads a T-pixel halo on all four sides into shared memory
// (out-of-image pixels take the variant's inert fills), runs T steps there
// and writes back the interior, which is then exactly T global Jacobi
// sweeps of the pass's input. Inside the slab every step is Jacobi too:
// each thread computes its pixels' new values into registers, and all
// threads write them back between two barriers, so a (bw, be) pair is
// never read torn. Out-of-image neighbours never contribute: the direction
// bits are masked by explicit bounds checks (the Pallas roll wraps, which
// is where its round-3 leak came from).
//
// What bounds it on the H100: the work inside the slab, not the bytes. A
// pass reads 2-4 planes and writes 1-3 (8 MB each at 1080p; 12 us at the
// HBM rate for labelnd), but a block that computes all (TILE + 2T)^2
// pixels in each of T steps does 2040 x 8 x 2304 x 8 shared-memory reads
// of each field per 1080p pass, >= 80 us at one 32-lane read per SM per
// clock before any compare or barrier. So this design does less work:
//
// 1. Settled tiles are skipped, as the reference skips settled strips
//    (its `act` vector and wake protocol). Each pass writes one byte per
//    tile to act_out: kActChanged if an interior pixel of the tile
//    changed in this pass, else 0. The next pass reads it as act_in, and a
//    block whose 3 x 3 tile neighbourhood in act_in is all zero returns at
//    once, writing only its act_out byte, 0. Its slab lies inside that
//    neighbourhood (T <= TILE), and no interior there changed in the
//    previous pass, so this pass's slab equals the previous pass's slab;
//    the pass is a function of the slab alone, so recomputing the tile
//    would reproduce the interior it has now. Every gated pass's output
//    therefore equals the ungated pass's output bit for bit (so do the
//    `changed` word and the pass count). act_in is null on a pass that
//    must run every tile: the first pass of a fixpoint and the pass after
//    a closure launch (the closures rewrite the planes in place). For a
//    seeded first pass (label_flood's seed_mask) the wrapper writes
//    kActSeed for each tile that holds a seed pixel; the caller's contract
//    is that a tile whose slab holds no seed is at a local fixpoint, so
//    its first pass changes nothing, which is what a skip reproduces.
//    The 3 x 3 dilation is the conservative rule: the reference's refined
//    wake (a self-wake on a last-step change, neighbours woken on band
//    changes) drops ring values still travelling inside the halo at step
//    T, so its pass-by-pass equality is not shown, and it is unsound for
//    subsum, which is not a join.
//    Both buffers: a skipped tile leaves its destination untouched, so the
//    destination must already hold the tile's current interior. Pass p
//    writes the buffer that pass p - 2 wrote; a tile skipped in pass p did
//    not change in pass p - 1 (it is its own neighbour), so the output of
//    pass p - 2 equals that of pass p - 1, which equals that of pass p.
//    That holds once both buffers hold the state: the wrapper copies the
//    caller's fields into the second scratch set before pass 1 (the one
//    pass 2 writes), and into the first too when pass 1 is seeded.
// 2. Inside an active tile, step s (1-based) computes only the pixels at
//    least s from the slab edge, (SLAB - 2s)^2 of them: those are all that
//    can still reach the interior, and their neighbours were all computed
//    at step s - 1. That is 12336 pixel-steps in place of 18432. Threads
//    take the square row-major, so most lanes stay busy as it shrinks.
//    Each step ends in __syncthreads_or of "a pixel changed": when none
//    did, the remaining steps are no-ops (the region only shrinks and
//    reads only what did not change), and the block goes to write-back.
//    The interior is still compared with the pass's input there, for the
//    `changed` word and act_out.
// 3. TILE stays 32: the skipping works at tile granularity, and a 64-pixel
//    tile (a smaller halo share) would skip 4x more coarsely.
//
// 4. T, the steps per pass, is a template parameter: 4 (the reference's
//    T_SCAN), 8 (the default), 16 (the reference's _pick_t at w >= 2560)
//    and 32 (= TILE, the largest the skip argument allows: a slab must lie
//    in its 3 x 3 tile neighbourhood). Each C entry takes the T of the call
//    and launches that instantiation; any other T is refused. The slab, its
//    shared memory and each thread's pixels per step grow with T: the
//    fields, the label plane and the bits live in dynamic shared memory
//    ((TILE + 2T)^2 pixels of 4 bytes a field, 4 for a label plane, 1 for
//    the bits: 36 KB for compmin at T = 8, 69 KB at T = 16, 153 KB at
//    T = 32), and each instantiation opts in to what it needs past 48 KB
//    on its first launch on each device. A failed opt-in or launch is
//    returned as the CUDA error; there is no other route. The skip stays
//    sound when T changes between two passes of a fixpoint (the hybrid
//    route's passes after the warm passes; only the joins take that
//    route): a join only raises, so a tile whose 3 x 3 neighbourhood did
//    not change in a pass of any T <= TILE is unchanged by one step
//    there, hence by any number of steps on its slab.
//
// Device counters per variant (g_tiles, shared by every T): tiles computed
// in unseeded passes, in seeded first passes, and the in-tile steps they
// ran, read back only by gseg_gossip_tile_counts, so the main path gains
// no host sync.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;             // interior side owned by one block
constexpr int THREADS = 256;
constexpr int NVARIANTS = 5;
constexpr size_t kDefaultSmem = 48 * 1024;  // shared memory without opt-in

// The slab of a T-step pass: its side (halo included), its pixels, and
// each thread's share of them in the load and in the largest computed
// square, (SLAB - 2)^2.
template <int T>
struct Slab {
    static_assert(T >= 1 && T <= TILE, "a slab must lie in its 3 x 3 tiles");
    static constexpr int SIDE = TILE + 2 * T;
    static constexpr int NPIX = SIDE * SIDE;
    static constexpr int LOAD_PPT = (NPIX + THREADS - 1) / THREADS;
    static constexpr int STEP_PPT =
        ((SIDE - 2) * (SIDE - 2) + THREADS - 1) / THREADS;
};
constexpr uint8_t kActChanged = 1;   // act bits: interior changed last pass
constexpr uint8_t kActSeed = 2;      // the tile holds a seed pixel

__device__ unsigned long long g_tiles[NVARIANTS][3];

// DIRS8 order: E, S, SE, NE, then the reverses W, N, NW, SW.
// dy: 0, 1, 1, 1, 0, -1, -1, -1; dx: 1, 0, 1, -1, -1, 0, -1, 1.
__host__ __device__ constexpr int dir_dy(int d) {
    return (d & 3) == 0 ? 0 : (d < 4 ? 1 : -1);
}
__host__ __device__ constexpr int dir_dx(int d) {
    return (d < 4 ? 1 : -1) * ((d & 3) == 1 ? 0 : ((d & 3) == 3 ? -1 : 1));
}

// What the read-only plane holds: a label plane (neighbours join when their
// labels are equal), packed allow bits (bit d: join with neighbour d), or
// parent directions (neighbour d is a child when its pdir is d's reverse).
enum class Ro { kLabel, kAllow, kPdir };

// Each Op: its index ID (g_tiles, the C entries' order), NRW read-write
// 32-bit fields, their out-of-image fill words, the kind of read-only
// plane, init (a pixel's new value before the joins, from its old one) and
// join (fold in neighbour n).
struct KeepOwn {
    static constexpr bool kFreshInit = false;
    template <int N>
    __device__ static void init(uint32_t (&c)[N], const uint32_t (&old)[N]) {
#pragma unroll
        for (int k = 0; k < N; ++k) c[k] = old[k];
    }
};

struct CompminOp : KeepOwn {  // fields: bw (f32 bits), be (i32), sz (i32)
    static constexpr int ID = 0;
    static constexpr int NRW = 3;
    static constexpr Ro RO = Ro::kLabel;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7f800000u : (k == 1 ? 0x7fffffffu : 0u);
    }
    template <int NPIX>
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        const float cw = __uint_as_float(c[0]);
        const float nw = __uint_as_float(f[0][n]);
        const int ne = static_cast<int>(f[1][n]);
        if (nw < cw || (nw == cw && ne < static_cast<int>(c[1]))) {
            c[0] = f[0][n];
            c[1] = f[1][n];
        }
        if (static_cast<int>(f[2][n]) > static_cast<int>(c[2])) c[2] = f[2][n];
    }
};

constexpr int BIGDIST = 1 << 30;  // dist of a pixel no seed has reached

struct LabelDistOp : KeepOwn {  // fields: Lc (i32), idf (f32 bits), dist (i32)
    static constexpr int ID = 1;
    static constexpr int NRW = 3;
    static constexpr Ro RO = Ro::kAllow;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7fffffffu
                      : (k == 1 ? 0u : static_cast<uint32_t>(BIGDIST));
    }
    template <int NPIX>
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        const int nl = static_cast<int>(f[0][n]);
        const int nd = static_cast<int>(f[2][n]);
        const int cand = nd >= BIGDIST ? BIGDIST : nd + 1;
        const int cl = static_cast<int>(c[0]);
        if (nl < cl || (nl == cl && cand < static_cast<int>(c[2]))) {
            c[0] = f[0][n];
            c[2] = static_cast<uint32_t>(cand);
        }
        if (__uint_as_float(f[1][n]) > __uint_as_float(c[1])) c[1] = f[1][n];
    }
};

struct LabelndOp : KeepOwn {  // fields: Lc (i32), idf (f32 bits)
    static constexpr int ID = 2;
    static constexpr int NRW = 2;
    static constexpr Ro RO = Ro::kAllow;
    __device__ static uint32_t fill(int k) {
        return k == 0 ? 0x7fffffffu : 0u;
    }
    template <int NPIX>
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        if (static_cast<int>(f[0][n]) < static_cast<int>(c[0])) c[0] = f[0][n];
        if (__uint_as_float(f[1][n]) > __uint_as_float(c[1])) c[1] = f[1][n];
    }
};

struct ValueOp : KeepOwn {  // field: val (i32)
    static constexpr int ID = 3;
    static constexpr int NRW = 1;
    static constexpr Ro RO = Ro::kLabel;
    __device__ static uint32_t fill(int) { return 0x7fffffffu; }
    template <int NPIX>
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        if (static_cast<int>(f[0][n]) < static_cast<int>(c[0])) c[0] = f[0][n];
    }
};

struct SubsumOp {  // field: s (i32); the bits mark the children; s starts at 1
    static constexpr int ID = 4;
    static constexpr int NRW = 1;
    static constexpr Ro RO = Ro::kPdir;
    // init ignores the old value, so an out-of-image pixel (no children)
    // would move off its fill: such pixels are left as they are.
    static constexpr bool kFreshInit = true;
    __device__ static uint32_t fill(int) { return 0u; }
    __device__ static void init(uint32_t (&c)[NRW], const uint32_t (&)[NRW]) {
        c[0] = 1u;
    }
    template <int NPIX>
    __device__ static void join(uint32_t (&c)[NRW],
                                uint32_t (*f)[NPIX], int n) {
        c[0] += f[0][n];
    }
};

template <int N>
struct Fields {
    const uint32_t* in[N];
    uint32_t* out[N];
};

// Dynamic shared memory of one block: the fields, the label plane (label
// and pdir planes only) and the direction bits.
template <class Op, int T>
constexpr size_t smem_bytes() {
    constexpr size_t n = Slab<T>::NPIX;
    return n * 4 * Op::NRW + (Op::RO != Ro::kAllow ? n * 4 : 0) + n;
}

// ro: the (H, W) read-only plane of kind Op::RO. act_in: the previous
// pass's (H/TILE, W/TILE) act bytes, or null to run every tile. act_out:
// this pass's.
template <class Op, int T>
__global__ void __launch_bounds__(THREADS)
fixpoint_pass(const int32_t* __restrict__ ro, Fields<Op::NRW> fl, int h,
              int w, const uint8_t* __restrict__ act_in,
              uint8_t* __restrict__ act_out, int32_t* __restrict__ changed) {
    constexpr int SLAB = Slab<T>::SIDE;
    constexpr int NPIX = Slab<T>::NPIX;
    constexpr int LOAD_PPT = Slab<T>::LOAD_PPT;
    constexpr int STEP_PPT = Slab<T>::STEP_PPT;
    constexpr bool kInShared = Op::RO != Ro::kAllow;
    // out-of-image fill of a shared ro plane: no label, no parent.
    constexpr int32_t kRoFill = Op::RO == Ro::kLabel ? -1 : 8;
    extern __shared__ __align__(16) unsigned char smem[];
    auto f = reinterpret_cast<uint32_t (*)[NPIX]>(smem);
    int32_t* lab = reinterpret_cast<int32_t*>(smem + 4 * NPIX * Op::NRW);
    // direction bits of each pixel
    uint8_t* nbits = smem + 4 * NPIX * Op::NRW + (kInShared ? 4 * NPIX : 0);

    const int tiles_x = static_cast<int>(gridDim.x);
    const int tiles_y = static_cast<int>(gridDim.y);
    const int bx = static_cast<int>(blockIdx.x);
    const int by = static_cast<int>(blockIdx.y);
    const int tile = by * tiles_x + bx;

    // 1. the skip: the same nine bytes in every thread (an L1 broadcast).
    uint32_t act = kActChanged;
    if (act_in != nullptr) {
        act = 0;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
                const int ty = by + dy, tx = bx + dx;
                if (ty >= 0 && ty < tiles_y && tx >= 0 && tx < tiles_x)
                    act |= act_in[ty * tiles_x + tx];
            }
    }
    if (act == 0) {
        if (threadIdx.x == 0) act_out[tile] = 0;
        return;
    }
    if (threadIdx.x == 0)
        atomicAdd(&g_tiles[Op::ID][act >= kActSeed ? 1 : 0], 1ull);

    const int y0 = by * TILE - T;
    const int x0 = bx * TILE - T;
#pragma unroll
    for (int j = 0; j < LOAD_PPT; ++j) {
        const int i = threadIdx.x + j * THREADS;
        if (i < NPIX) {
            const int gy = y0 + i / SLAB, gx = x0 + i % SLAB;
            const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
            const size_t g = static_cast<size_t>(gy) * w + gx;
#pragma unroll
            for (int k = 0; k < Op::NRW; ++k)
                f[k][i] = inside ? fl.in[k][g] : Op::fill(k);
            if constexpr (kInShared) lab[i] = inside ? ro[g] : kRoFill;
            else nbits[i] = inside ? static_cast<uint8_t>(ro[g] & 0xff) : 0;
        }
    }
    __syncthreads();

    // Direction bits, once per pass, for the pixels that are ever computed
    // (at least one from the slab edge, so every neighbour is in the slab):
    // the neighbour lies in the image (and, for label planes, has the same
    // label; for parent directions, is a child: its pdir is d's reverse
    // (d + 4) % 8). Each thread reads and writes only its own pixels' bytes.
    constexpr int NB = SLAB - 2;
    for (int r = threadIdx.x; r < NB * NB; r += THREADS) {
        const int ly = 1 + r / NB, lx = 1 + r % NB;
        const int i = ly * SLAB + lx;
        const int gy = y0 + ly, gx = x0 + lx;
        uint32_t b = 0;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
#pragma unroll
            for (int d = 0; d < 8; ++d) {
                const int gny = gy + dir_dy(d), gnx = gx + dir_dx(d);
                const int n = i + dir_dy(d) * SLAB + dir_dx(d);
                bool ok = gny >= 0 && gny < h && gnx >= 0 && gnx < w;
                if constexpr (Op::RO == Ro::kLabel)
                    ok = ok && lab[n] == lab[i];
                else if constexpr (Op::RO == Ro::kPdir)
                    ok = ok && lab[n] == ((d + 4) & 7);
                else ok = ok && ((nbits[i] >> d) & 1u);
                b |= static_cast<uint32_t>(ok) << d;
            }
        }
        nbits[i] = static_cast<uint8_t>(b);
    }
    __syncthreads();

    // 2. T steps on a shrinking square, stopping when one changes nothing.
    int steps = T;
    for (int s = 1; s <= T; ++s) {
        const uint32_t n = SLAB - 2 * s;
        const uint32_t npx = n * n;
        // r / n as a multiply-high: exact for r < 2^16 (the error term
        // r / 2^32 stays below the 1/n gap to the next integer).
        const uint32_t magic = 0xffffffffu / n + 1u;
        uint32_t nv[STEP_PPT][Op::NRW];
        bool any = false;
#pragma unroll
        for (int j = 0; j < STEP_PPT; ++j) {
            const uint32_t r = threadIdx.x + j * THREADS;
            if (r < npx) {
                const uint32_t q = __umulhi(r, magic);
                const int ly = s + static_cast<int>(q);
                const int lx = s + static_cast<int>(r - q * n);
                const int i = ly * SLAB + lx;
                uint32_t old[Op::NRW];
#pragma unroll
                for (int k = 0; k < Op::NRW; ++k) old[k] = f[k][i];
                Op::init(nv[j], old);
                const uint32_t b = nbits[i];
#pragma unroll
                for (int d = 0; d < 8; ++d)
                    if ((b >> d) & 1u)
                        Op::join(nv[j], f, i + dir_dy(d) * SLAB + dir_dx(d));
                if constexpr (Op::kFreshInit) {
                    const int gy = y0 + ly, gx = x0 + lx;
                    if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
#pragma unroll
                        for (int k = 0; k < Op::NRW; ++k) nv[j][k] = old[k];
                    }
                }
#pragma unroll
                for (int k = 0; k < Op::NRW; ++k)
                    any = any || nv[j][k] != old[k];
            }
        }
        if (!__syncthreads_or(any)) {
            steps = s;
            break;
        }
#pragma unroll
        for (int j = 0; j < STEP_PPT; ++j) {
            const uint32_t r = threadIdx.x + j * THREADS;
            if (r < npx) {
                const uint32_t q = __umulhi(r, magic);
                const int i = (s + static_cast<int>(q)) * SLAB + s +
                              static_cast<int>(r - q * n);
#pragma unroll
                for (int k = 0; k < Op::NRW; ++k) f[k][i] = nv[j][k];
            }
        }
        __syncthreads();
    }

    // Write-back of the interior, a warp per 32-pixel row.
    bool any = false;
    for (int r = threadIdx.x; r < TILE * TILE; r += THREADS) {
        const int ly = T + r / TILE, lx = T + r % TILE;
        const int gy = y0 + ly, gx = x0 + lx;
        if (gy >= h || gx >= w) continue;
        const size_t g = static_cast<size_t>(gy) * w + gx;
        const int i = ly * SLAB + lx;
#pragma unroll
        for (int k = 0; k < Op::NRW; ++k) {
            const uint32_t v = f[k][i];
            any = any || v != fl.in[k][g];
            fl.out[k][g] = v;
        }
    }
    const int tile_changed = __syncthreads_or(any);
    if (threadIdx.x == 0) {
        atomicAdd(&g_tiles[Op::ID][2], static_cast<unsigned long long>(steps));
        act_out[tile] = tile_changed ? kActChanged : 0;
        if (tile_changed) atomicOr(changed, 1);
    }
}

template <class Op, int T>
int launch_t(const void* ro, Fields<Op::NRW> fl, int h, int w,
             const void* act_in, void* act_out, void* changed, void* stream) {
    constexpr size_t bytes = smem_bytes<Op, T>();
    if constexpr (bytes > kDefaultSmem) {
        // the opt-in past the default 48 KB, once per instantiation and
        // device (a bit per device).
        static std::atomic<unsigned long long> opted{0};
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        const unsigned long long bit = 1ull << (dev & 63);
        if (!(opted.load() & bit)) {
            err = cudaFuncSetAttribute(
                fixpoint_pass<Op, T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(bytes));
            if (err != cudaSuccess) return static_cast<int>(err);
            opted.fetch_or(bit);
        }
    }
    const dim3 grid((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
    fixpoint_pass<Op, T><<<grid, THREADS, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ro), fl, h, w,
        static_cast<const uint8_t*>(act_in), static_cast<uint8_t*>(act_out),
        static_cast<int32_t*>(changed));
    return static_cast<int>(cudaGetLastError());
}

template <class Op>
int launch(int t, const void* ro, Fields<Op::NRW> fl, int h, int w,
           const void* act_in, void* act_out, void* changed, void* stream) {
    switch (t) {
        case 4: return launch_t<Op, 4>(ro, fl, h, w, act_in, act_out,
                                       changed, stream);
        case 8: return launch_t<Op, 8>(ro, fl, h, w, act_in, act_out,
                                       changed, stream);
        case 16: return launch_t<Op, 16>(ro, fl, h, w, act_in, act_out,
                                         changed, stream);
        case 32: return launch_t<Op, 32>(ro, fl, h, w, act_in, act_out,
                                         changed, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

constexpr int kSteps[] = {4, 8, 16, 32};  // the instantiated T

}  // namespace

extern "C" {

// 1 if the step kernel is instantiated for t steps per pass, else 0.
int gseg_gossip_has_steps(int t) {
    for (int k : kSteps)
        if (k == t) return 1;
    return 0;
}

int gseg_gossip_tile() { return TILE; }

// Since the last reset, per variant (in the order of the entries below):
// tiles computed in unseeded passes, in seeded first passes, and the steps
// they ran; 15 counts into out. Synchronous.
int gseg_gossip_tile_counts(unsigned long long* out) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, g_tiles, sizeof(g_tiles)));
}

int gseg_gossip_reset_tile_counts() {
    static const unsigned long long zero[NVARIANTS][3] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_tiles, zero, sizeof(zero)));
}

int gseg_compmin_pass(const void* L, const void* bw_in, const void* be_in,
                      const void* sz_in, void* bw_out, void* be_out,
                      void* sz_out, int h, int w, int t, const void* act_in,
                      void* act_out, void* changed, void* stream) {
    Fields<3> fl{{static_cast<const uint32_t*>(bw_in),
                  static_cast<const uint32_t*>(be_in),
                  static_cast<const uint32_t*>(sz_in)},
                 {static_cast<uint32_t*>(bw_out), static_cast<uint32_t*>(be_out),
                  static_cast<uint32_t*>(sz_out)}};
    return launch<CompminOp>(t, L, fl, h, w, act_in, act_out, changed,
                             stream);
}

int gseg_labeldist_pass(const void* allow, const void* L_in,
                        const void* idf_in, const void* dist_in, void* L_out,
                        void* idf_out, void* dist_out, int h, int w, int t,
                        const void* act_in, void* act_out, void* changed,
                        void* stream) {
    Fields<3> fl{{static_cast<const uint32_t*>(L_in),
                  static_cast<const uint32_t*>(idf_in),
                  static_cast<const uint32_t*>(dist_in)},
                 {static_cast<uint32_t*>(L_out), static_cast<uint32_t*>(idf_out),
                  static_cast<uint32_t*>(dist_out)}};
    return launch<LabelDistOp>(t, allow, fl, h, w, act_in, act_out, changed,
                               stream);
}

int gseg_labelnd_pass(const void* allow, const void* L_in, const void* idf_in,
                      void* L_out, void* idf_out, int h, int w, int t,
                      const void* act_in, void* act_out, void* changed,
                      void* stream) {
    Fields<2> fl{{static_cast<const uint32_t*>(L_in),
                  static_cast<const uint32_t*>(idf_in)},
                 {static_cast<uint32_t*>(L_out), static_cast<uint32_t*>(idf_out)}};
    return launch<LabelndOp>(t, allow, fl, h, w, act_in, act_out, changed,
                             stream);
}

int gseg_value_pass(const void* L, const void* val_in, void* val_out, int h,
                    int w, int t, const void* act_in, void* act_out,
                    void* changed, void* stream) {
    Fields<1> fl{{static_cast<const uint32_t*>(val_in)},
                 {static_cast<uint32_t*>(val_out)}};
    return launch<ValueOp>(t, L, fl, h, w, act_in, act_out, changed, stream);
}

int gseg_subsum_pass(const void* pdir, const void* s_in, void* s_out, int h,
                     int w, int t, const void* act_in, void* act_out,
                     void* changed, void* stream) {
    Fields<1> fl{{static_cast<const uint32_t*>(s_in)},
                 {static_cast<uint32_t*>(s_out)}};
    return launch<SubsumOp>(t, pdir, fl, h, w, act_in, act_out, changed,
                            stream);
}

}  // extern "C"
