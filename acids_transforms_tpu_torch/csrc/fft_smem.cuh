// Shared-memory FFT of frames for Hopper (sm_90a): frames_rfft, its inverse
// frames_irfft, and frames_roundtrip (one, then the other, in one team).
//
// Replaces the window-folded full-length products for every n_fft that
// fft_covers() takes (a power of two from 64 to 4096;
// ops/cuda/frames_fft.py:fft_covers is the wrapper's copy of the rule); the
// other shapes keep the products.  frames_rfft replaces the analysis product
// (stream_step.cu:fullk_analysis, dft_common.cuh:analysis_tile with klen =
// n_fft), frames_irfft the synthesis product (synth_ola.cuh:synth_ola_tile),
// in the kernels whose TPU originals compute a windowed real DFT of every
// frame, or its inverse:
//   stream_step.cu:session_encode_kernel<., true>  <- ops/pallas/stream_step.py:
//       _session_forward_kernel (R) and _analyze_mag (the magnitude encode of N)
//   spectral.cu:block_magnitudes<., kFrontFft>     <- ops/pallas/spectral.py:
//       _forward_kernel (E) and _stats_kernel (F), full-K
//   spectral.cu:repr_forward_kernel / repr_stats_kernel<., kFrontFft>
//                                                  <- ops/pallas/spectral.py:
//       _repr_kernel (G) and _repr_stats_kernel (H), full-K
//   glstep_fullk.cu:gl_fullk_fft_kernel            <- ops/pallas/glstep.py:
//       _gl_kernel_fullk_momentum (J): frames_irfft, then frames_rfft
//   stream_step.cu:session_roundtrip_fft_kernel    <- ops/pallas/stream_step.py:
//       _session_kernel (L) and _session_random_kernel (M): frames_roundtrip
//   pghi.cu:pghi_synthesize_fft_kernel             <- ops/pallas/pghi_kernel.py:
//       _pghi_invert_kernel's synthesis (K): frames_irfft
//   glstep.cu:gl_step_fft_kernel                   <- ops/pallas/glstep.py:
//       _gl_kernel_momentum (C), _gl_kernel_momentum_chain (D), _gl_kernel (I):
//       frames_irfft, then frames_rfft
//   stream_step.cu:session_decode_fft_kernel       <- ops/pallas/stream_step.py:
//       _session_random_invert_kernel (P), _session_complex_invert_kernel (S),
//       the synthesis of _session_pghi_gl_kernel's projection (O): frames_irfft
//   stream_step.cu:gl_polish_fft_kernel            <- ops/pallas/stream_step.py:
//       _session_pghi_gl_kernel's projections (O): frames_irfft, then frames_rfft
//   stream_step.cu:gl_project_analysis_fft_kernel  <- the analysis of those
//       projections where the polish's block cannot hold the grid: frames_rfft
// and, as the mixed-radix route (template argument kSmooth = true) where
// fft_covers_smooth() takes n_fft (even, 2^a 3^b 5^c, 64 to 4096, no power of
// two: 1200, 960, 768, 400, 1920, ...), in R, the magnitude encode of N, L, M,
// the decodes P, S and O's projection synthesis, E and F (so A and B), G and
// H (full-K and under the taps' window), the Griffin-Lim steps J, C, D and I,
// K's synthesis, O's polish and O's two-launch analysis (session_encode_kernel<., true, true>,
// session_roundtrip_fft_kernel<., true>, session_decode_fft_kernel<., true>,
// spectral.cu:block_magnitudes<., kFrontSmooth>, spectral.cu:
// repr_forward_kernel / repr_stats_kernel<., kFrontSmooth>,
// glstep_fullk.cu:gl_fullk_fft_kernel<true>, glstep.cu:gl_step_fft_kernel<true>,
// pghi.cu:pghi_synthesize_fft_kernel<true>, stream_step.cu:gl_polish_fft_kernel<.,
// true>, stream_step.cu:gl_project_analysis_fft_kernel<true, false>).  With a
// radix-7 stage as well (template argument kSeven = true) where
// fft_covers_smooth7() takes n_fft and n_fft has a factor 7 (even, 2^a 3^b 5^c
// 7^d: 896, 1344, 1680, 1764, ...), in R, the magnitude encode of N, L, M,
// the decodes P, S and O's projection synthesis, E and F (so A and B), G and
// H (full-K and under the taps' window), the Griffin-Lim steps J, C, D and I,
// K's synthesis, O's polish and O's two-launch analysis
// (session_encode_kernel<., true, true, true>,
// session_roundtrip_fft_kernel<., true, true>, session_decode_fft_kernel<.,
// true, true>, spectral.cu:block_magnitudes<., kFrontSmooth7>, spectral.cu:
// repr_forward_kernel / repr_stats_kernel<., kFrontSmooth7>,
// glstep_fullk.cu:gl_fullk_fft_kernel<true, true>, glstep.cu:
// gl_step_fft_kernel<true, true>, pghi.cu:pghi_synthesize_fft_kernel<true,
// true>, stream_step.cu: gl_polish_fft_kernel<., true, true>,
// gl_project_analysis_fft_kernel<true, true>), each where its block fits;
// every other n_fft (1408, 8192, ...) keeps the product or factored routes.
//
// What they compute.  frames_rfft: X_r[k] = sum_n w[n] xs[r hop + n] e^{-2 pi
// i n k / n} for k <= n / 2 of every frame r < n_frames of a sample buffer
// already in shared memory, handed to emit(r, k, re, im): the contract of
// fullk_analysis's emit.  frames_irfft: y_r[i] = wsyn[i] sum_k c_k Re(X_r[k]
// e^{2 pi i k i / n}) (c_0 = c_{n/2} = 1, else 2; wsyn the synthesis window
// over n) of spectra the caller hands in bin by bin, handed to emit(r, i, v)
// so that the caller adds them into its own sample buffer.  Float32
// throughout.
//
// What bounds them on this card: bytes.  An FFT needs about 2.5 n log2 n
// operations a frame (25.6 K at n = 1024), far below the fp32 ridge of 67
// TFLOP/s over 3.35 TB/s = 20 flop a byte; R's function at 1024/256 and 64
// sessions x 688 frames moves 0.067 ms of bytes, E's 0.081 ms, J's (nine
// (B, T, F) arrays) 0.487 ms.  The products they replace did n x F x 2
// multiply-adds a frame and direction (1.05 M), 41 times an FFT's
// operations, so their own fp32 ceiling (1.7 ms for R, 2.8 ms for E, 6.8 ms
// for J, 3.3 ms for L) sat above the cuFFT yardstick.  This design reads the
// samples or the spectra once, reads no basis (the window and the twiddle
// table, n + 1.5 n floats, are staged once a block), and does an FFT's
// operations.  What is left is shared-memory traffic (each pass reads and
// writes the pair's 2 n floats), the barriers between passes, and, for the
// inverse, the overlap-add's class order: a block barrier between classes.
//
// Design.
// * Two real frames per complex FFT: frames 2j and 2j + 1 of the caller's
//   numbering go in as z[n] = w[n] x_2j[n] + i w[n] x_2j+1[n]; the split is
//   X_2j[k] = (Z[k] + conj Z[n-k]) / 2, X_2j+1[k] = (Z[k] - conj Z[n-k]) / 2i.
//   An odd last frame pairs with a zero frame.
// * A team of n / 16 threads runs one pair (two warps at n = 1024, the whole
//   block at 4096, several teams to a warp below 512), so that each thread
//   holds 16 complex values in registers at every size; the block's 4096 / n
//   teams run pairs side by side, in rounds.  A team syncs with __syncwarp
//   (one warp or less) or a named barrier (bar.sync 1 + team).  Every thread
//   runs every round, busy or not, so the barriers see all their threads.
// * Stockham auto-sort, radix 4, then one radix-2 pass when log2 n is odd;
//   the result comes out in natural order.  Stage with stride s: butterfly b
//   < n / 4 reads x[b + k n / 4], k < 4, and writes y[4 b - 3 q + s k] (q = b
//   mod s), outputs 1-3 turned by e^{-2 pi i k (b - q) / n}.  Two stages
//   (strides s and 4 s) share one trip through shared memory: the thread of
//   group g = q + s p' (q < s) reads the inputs of stage-s butterflies q + s
//   (p' + u n / 16s), u < 4, whose 16 outputs are exactly the inputs of the
//   stage-4s butterflies q + s k + 4 s p', k < 4; it runs both in registers
//   and writes their outputs.  The arithmetic is the two stages' own, value
//   for value.  A last odd radix-4 stage runs alone (4 butterflies a thread);
//   the radix-2 stage (s = n / 2) reads and writes the same two places.  In
//   place: a thread's 16 inputs wait in registers across a team barrier.
//   At n = 1024 that is three trips (strides 1 + 4, 16 + 64, 256) instead of
//   five, plus the load and the split.
// * The pair's re and im live in a per-team buffer, each 32-float block
//   permuted by an XOR of its low 5 bits with a function of the block index
//   (fft_swz), so that the strided writes of the first two trips (stride 16,
//   then runs of 16 at stride 256) and the contiguous reads all fall on 32
//   distinct banks for a warp's 32 lanes; teams that share a warp start n /
//   32 floats apart (other banks).
// * Twiddles: the table e^{-2 pi i j / n}, j < 3 n / 4, built in float64 on
//   the host and rounded once (no sincos on the card, no --use_fast_math),
//   and the window, staged once a block (fft_stage).
// * Every product and sum is __fmul_rn / __fadd_rn / __fsub_rn: nothing is
//   contracted, so the plain versions (ops/cuda/frames_fft.py:
//   frames_rfft_reference, frames_irfft_reference), which repeat these
//   operations in this order, round alike.
// * A pair stride: frames r and r + stride share an FFT (pairs of frames
//   2 stride g + c and stride more, c < stride; stride 1, the default, is
//   (2j, 2j + 1) as before).
// * The inverse as the forward passes: Z = X_a + i X_b packed over k < n
//   (X[n - k] = conj X[k]) goes in as conj Z, and conj(FFT(conj Z)) / n
//   comes out as x_a + i x_b: the same passes, table and swizzle, the sign
//   flipped at load and at store, 1 / n folded into wsyn (exact: n is a
//   power of two).  The pack reads the imaginary parts at DC and nyquist of
//   neither frame (irfft ignores them, and the packed FFT would not).
// * The overlap-add with no atomics: with stride = n / hop (the overlap) the
//   frames of one class r mod stride tile the signal without overlapping,
//   so the teams of a class add straight into the caller's buffer; the
//   classes run in order with a block barrier between them, so each sample
//   collects its terms in class order, which the plain version
//   (frames_fft.overlap_add_classes) repeats.  The callers number their
//   frames so that a block's first frame starts a pair group of the whole
//   signal: no frame's rounding depends on the block that computes it.
// * frames_roundtrip keeps each pair's spectrum in its team's buffer: the
//   forward FFT, the split (and the caller's change of the bins) and the
//   pack write exactly the places they read, so the inverse follows with
//   no barrier beyond the team's.
//
// The mixed-radix route (kSmooth).  The same pairs, split, pack, inverse and
// class order; what differs:
// * the stages: Stockham auto-sort over the radices of fft_smooth_plan
//   (sevens, fives, threes, fours, then a two when log2 of n's power of two
//   is odd; ops/cuda/frames_fft.py:fft_radices), one stage per trip: stage
//   radix r, stride s: butterfly b < n / r reads x[b + k n / r], takes the
//   length-r DFT (fft_dft: radix 3, 5 and 7 with constants rounded once from
//   float64, kR3S .. kR7S3) and writes y[r (b - q) + q + s k] (q = b mod s),
//   outputs 1 .. r - 1 turned by the table's entries k (b - q); the last
//   stage has b - q = 0 for every butterfly, so it turns nothing and writes
//   where it reads.  1200 = 5 5 3 4 4: five trips; 1344 = 7 3 4 4 4.
// * the radix-7 stage is compiled only into the instances that take a
//   factor 7 (kSeven: R's, L's, the decode's, E's, F's, G's, H's, J's, C's
//   (so D's and I's), K's synthesis's, O's polish's and O's analysis's):
//   fft_passes_smooth<false> holds no
//   radix-7 loop and fft_smooth_plan<false> no count of sevens, so every
//   other mixed-radix instance compiles as it did before the stage existed.
//   Its butterfly (fft_dft<7>, the symmetric form of frames_fft._dft7) holds
//   the 14 inputs, 12 sums and differences and a pair of partial sums.
// * out of place: the stages alternate between the team's buffer (re, im)
//   and a second half (re2, im2), one team barrier a stage, a butterfly at a
//   time in registers; the last stage runs in place when the others are
//   even in number, so the result lands in (re, im) as the in-place
//   power-of-two passes leave it.  Why not in place: a thread would hold a
//   stage's inputs (up to 20 values) through a barrier, which spilled
//   364-1288 B at 128 registers and made R 1.6x slower at 1200/300 (H100).
// * the team: the least power of two G of threads at or above n / 16
//   (fft_smooth_team_threads: 128 at 1200 and 1920, 64 at 960 and 768), so
//   that teams tile warps and the named barriers count whole warps, and a
//   thread owns 8 to 16 of a pair's values; a stage's n / r butterflies go round the
//   team (b = j + u G), the lanes past n / r idle in the last round.
// * the buffer: no swizzle (n is no multiple of 32, and the XOR of fft_swz
//   would leave the buffer).  The reads x[b + k n / r] are contiguous across
//   a warp's lanes; the odd radices run first, where their stride-r writes
//   (s = 1) fall on distinct banks for r = 3, 5, 7; the later strides' writes
//   mix runs of s lanes: at 1200 the writes of stages 2-4 are 1.88, 2.15
//   and 1.30 ways on average, 3 at most (counted from the address pattern:
//   tools/fft_bank_conflicts.py).  Teams that share a warp start G banks
//   apart.
// * the twiddle table: j < fft_smooth_table(n), the largest k (b - q) + 1 of
//   a stage before the last ((r - 1)(n / r - s) + 1: 957 at 1200).
// * the inverse's 1 / n rounds (n is no power of two): it is folded into
//   wsyn by the caller, rounded once from float64 (frames_fft.irfft_window(
//   smooth=True)), and the plain version reads the same table.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "dft_common.cuh"

namespace att {

constexpr int kFftMin = 64;
constexpr int kFftMax = 4096;
constexpr int kFftValues = 16;  // complex values a thread holds in a pass

__host__ __device__ inline bool fft_covers(int n) {
    return n >= kFftMin && n <= kFftMax && (n & (n - 1)) == 0;
}

// threads that run one FFT together
__host__ __device__ inline int fft_team_threads(int n) { return n / kFftValues; }

__host__ __device__ inline int fft_max_teams(int n) { return kThreads / fft_team_threads(n); }

// one team's buffer: re and im of n values, then n / 32 floats that move the
// next team onto other banks
__host__ __device__ inline int fft_buf_floats(int n) { return 2 * n + n / 32; }

// window, twiddles (cos and -sin, j < 3 n / 4) and the teams' buffers
__host__ __device__ inline size_t fft_smem_floats(int n, int teams) {
    return (size_t)n + 2 * (size_t)(3 * n / 4) + (size_t)teams * fft_buf_floats(n);
}

// ---- the mixed-radix route's rule, plan and layout (frames_fft.py twins)

// sin(pi / 3); cos(2 pi / 5), cos(4 pi / 5), sin(2 pi / 5), sin(4 pi / 5);
// cos and sin of 2 pi / 7, 4 pi / 7 and 6 pi / 7: float64 rounded once
// (frames_fft.SMOOTH_CONSTANTS)
constexpr float kR3S = 0x1.bb67aep-1f;
constexpr float kR5C1 = 0x1.3c6ef4p-2f;
constexpr float kR5C2 = -0x1.9e377ap-1f;
constexpr float kR5S1 = 0x1.e6f0e2p-1f;
constexpr float kR5S2 = 0x1.2cf230p-1f;
constexpr float kR7C1 = 0x1.3f3a0ep-1f;
constexpr float kR7C2 = -0x1.c7b90ep-3f;
constexpr float kR7C3 = -0x1.cd4bcap-1f;
constexpr float kR7S1 = 0x1.904c38p-1f;
constexpr float kR7S2 = 0x1.f329c0p-1f;
constexpr float kR7S3 = 0x1.bc4c04p-2f;

// even, 2^a 3^b 5^c 7^d, 64 to 4096, no power of two (frames_fft.fft_covers_smooth7):
// the route of every kernel with a mixed-radix instance
__host__ __device__ inline bool fft_covers_smooth7(int n) {
    if (n < kFftMin || n > kFftMax || (n & 1) || (n & (n - 1)) == 0) return false;
    while (n % 2 == 0) n /= 2;
    while (n % 3 == 0) n /= 3;
    while (n % 5 == 0) n /= 5;
    while (n % 7 == 0) n /= 7;
    return n == 1;
}

// sevens, fives, threes, fours, then a two (frames_fft.fft_radices).
// kSeven defaults to false here and in every template below: an instance
// counts sevens only where it says so.  fft_smooth_plan<false> takes n with
// no factor 7 (frames_fft.fft_covers_smooth(n): the entries of every instance
// without the radix-7 stage admit no other n); the layout's size,
// fft_smooth_smem_floats, counts them for every n.
struct FftPlan {
    int n7, n5, n3, n4, n2;
};

template <bool kSeven = false>
__host__ __device__ inline FftPlan fft_smooth_plan(int n) {
    FftPlan p = {0, 0, 0, 0, 0};
    if constexpr (kSeven) {
        while (n % 7 == 0) { ++p.n7; n /= 7; }
    }
    while (n % 5 == 0) { ++p.n5; n /= 5; }
    while (n % 3 == 0) { ++p.n3; n /= 3; }
    while (n % 4 == 0) { ++p.n4; n /= 4; }
    if (n == 2) p.n2 = 1;
    return p;
}

// the least power of two G with n / G <= 16 (8 to 16 values a thread)
__host__ __device__ inline int fft_smooth_team_threads(int n) {
    int g = 1;
    while (16 * g < n) g *= 2;
    return g;
}

__host__ __device__ inline int fft_smooth_max_teams(int n) { return kThreads / fft_smooth_team_threads(n); }

// twiddle entries the stages read: max (r - 1)(n / r - s) + 1 before the last stage
template <bool kSeven = false>
__host__ __device__ inline int fft_smooth_table(int n) {
    const FftPlan p = fft_smooth_plan<kSeven>(n);
    const int n_st = p.n7 + p.n5 + p.n3 + p.n4 + p.n2;
    int s = 1, out = 1, st = 0;
    auto stage = [&](int r) {
        if (st < n_st - 1) {
            const int e = (r - 1) * (n / r - s) + 1;
            out = e > out ? e : out;
        }
        s *= r;
        ++st;
    };
    for (int i = 0; i < p.n7; ++i) stage(7);
    for (int i = 0; i < p.n5; ++i) stage(5);
    for (int i = 0; i < p.n3; ++i) stage(3);
    for (int i = 0; i < p.n4; ++i) stage(4);
    for (int i = 0; i < p.n2; ++i) stage(2);
    return out;
}

// re and im of n values, then the stages' second half (re2, im2); teams
// sharing a warp start G banks apart
__host__ __device__ inline int fft_smooth_buf_floats(int n) {
    const int g = fft_smooth_team_threads(n);
    return 4 * n + (g < 32 ? (((g - 4 * n) % 32) + 32) % 32 : 0);
}

__host__ __device__ inline size_t fft_smooth_smem_floats(int n, int teams) {
    return (size_t)n + 2 * (size_t)fft_smooth_table<true>(n) + (size_t)teams * fft_smooth_buf_floats(n);
}

template <bool kSmooth>
__host__ __device__ inline int fft_buf_floats_of(int n) {
    return kSmooth ? fft_smooth_buf_floats(n) : fft_buf_floats(n);
}

// the FFT area of the route n takes: fft_covers(n), else the mixed-radix one
__host__ __device__ inline size_t fft_area_floats(int n, int teams) {
    return fft_covers(n) ? fft_smem_floats(n, teams) : fft_smooth_smem_floats(n, teams);
}

struct FftSmem {
    float* win;  // [n]
    float* twr;  // [3 n / 4]  cos(2 pi j / n)  (kSmooth: [fft_smooth_table(n)])
    float* twi;  // [3 n / 4] -sin(2 pi j / n)
    float* buf;  // [teams][fft_buf_floats(n)]  (kSmooth: fft_smooth_buf_floats)
};

template <bool kSmooth = false, bool kSeven = false>
__device__ __forceinline__ FftSmem carve_fft(float* base, int n) {
    const int nt = kSmooth ? fft_smooth_table<kSeven>(n) : 3 * n / 4;
    FftSmem s;
    s.win = base;
    s.twr = s.win + n;
    s.twi = s.twr + nt;
    s.buf = s.twi + nt;
    return s;
}

// The window (n floats) and the twiddle table ((2, n) floats: cos, -sin) from
// device memory into shared memory.  No barrier: frames_rfft starts with one.
template <bool kSmooth = false, bool kSeven = false>
static __device__ void fft_stage(const float* __restrict__ window, const float* __restrict__ tw,
                                 FftSmem s, int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) s.win[i] = __ldg(window + i);
    const int nt = kSmooth ? fft_smooth_table<kSeven>(n) : 3 * n / 4;
    for (int i = threadIdx.x; i < nt; i += kThreads) {
        s.twr[i] = __ldg(tw + i);
        s.twi[i] = __ldg(tw + n + i);
    }
}

// Where value i of a buffer lives: the same 32-float block, its offset XORed
// with h(B) = (B mod 16) + 16 ((B >> 3) mod 2) of the block index B.  A
// warp's stride-16 writes (two lanes a block, 16 blocks) then differ in bits
// 0-3 across blocks and in bit 4 within one; its two runs of 16 at stride 256
// (blocks B and B + 8) in bit 4.
__device__ __forceinline__ int fft_swz(int i) {
    const int B = i >> 5;
    return i ^ ((B & 15) | ((B & 8) << 1));
}

// where value i of a team's buffer lives on the route: swizzled, or in place
template <bool kSmooth>
__device__ __forceinline__ int fft_idx(int i) {
    if constexpr (kSmooth) {
        return i;
    } else {
        return fft_swz(i);
    }
}

__device__ __forceinline__ void fft_team_sync(int team, int G) {
    if (G <= 32) {
        __syncwarp();
    } else {
        asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(G) : "memory");
    }
}

// One radix-4 butterfly in registers, in place: inputs (r[k], i[k]), k < 4,
// become the outputs, 1-3 turned by the table's entries k t.
__device__ __forceinline__ void fft_bfly4(float (&r)[4], float (&i)[4], int t, const FftSmem& s) {
    const float apc_r = __fadd_rn(r[0], r[2]), apc_i = __fadd_rn(i[0], i[2]);
    const float amc_r = __fsub_rn(r[0], r[2]), amc_i = __fsub_rn(i[0], i[2]);
    const float bpd_r = __fadd_rn(r[1], r[3]), bpd_i = __fadd_rn(i[1], i[3]);
    const float bmd_r = __fsub_rn(r[1], r[3]), bmd_i = __fsub_rn(i[1], i[3]);
    // -i (b - d) = (bmd_i, -bmd_r)
    float ur[4], ui[4];
    ur[0] = __fadd_rn(apc_r, bpd_r);
    ui[0] = __fadd_rn(apc_i, bpd_i);
    ur[1] = __fadd_rn(amc_r, bmd_i);
    ui[1] = __fsub_rn(amc_i, bmd_r);
    ur[2] = __fsub_rn(apc_r, bpd_r);
    ui[2] = __fsub_rn(apc_i, bpd_i);
    ur[3] = __fsub_rn(amc_r, bmd_i);
    ui[3] = __fadd_rn(amc_i, bmd_r);
    r[0] = ur[0];
    i[0] = ui[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        const float wr = s.twr[k * t], wi = s.twi[k * t];
        r[k] = __fsub_rn(__fmul_rn(ur[k], wr), __fmul_rn(ui[k], wi));
        i[k] = __fadd_rn(__fmul_rn(ur[k], wi), __fmul_rn(ui[k], wr));
    }
}

// One team's view of the FFT area: its buffer (re, im), its index and the
// thread's index in it.  Threads past the last team point at team 0's buffer
// and are never active.
struct FftTeam {
    float* re;
    float* im;
    int team, j, G;
    bool has_team;
};

template <bool kSmooth = false>
__device__ __forceinline__ FftTeam fft_team(const FftSmem& s, int n, int teams) {
    FftTeam t;
    t.G = kSmooth ? fft_smooth_team_threads(n) : fft_team_threads(n);
    t.team = threadIdx.x / t.G;
    t.j = threadIdx.x - t.team * t.G;
    t.has_team = t.team < teams;
    t.re = s.buf + (size_t)(t.has_team ? t.team : 0) * fft_buf_floats_of<kSmooth>(n);
    t.im = t.re + n;
    return t;
}

// The windowed frames x0 (and x1 when `two`, else zeros) into the team's
// buffer as re and im.
template <bool kSmooth = false>
__device__ __forceinline__ void fft_load_pair(const FftTeam& t, const float* x0, const float* x1,
                                              bool two, int n, const FftSmem& s) {
    for (int i = t.j; i < n; i += t.G) {
        const float w = s.win[i];
        t.re[fft_idx<kSmooth>(i)] = __fmul_rn(w, x0[i]);
        t.im[fft_idx<kSmooth>(i)] = two ? __fmul_rn(w, x1[i]) : 0.0f;
    }
}

// The forward complex FFT of the team's buffer in place, natural order (the
// Stockham passes of the note above).  Starts with a team barrier (the
// buffer's writes are visible) and ends with one (the result is).  Every
// thread of the block calls it; `active` those whose team holds a pair.
__device__ __forceinline__ void fft_passes(const FftTeam& t, bool active, int n, const FftSmem& s) {
    const int team = t.team, G = t.G, j = t.j;
    float* re = t.re;
    float* im = t.im;
    const int quarter = n >> 2;
    const int half = n >> 1;
    const int sixteenth = n >> 4;
    const int lg = 31 - __clz(n);
    fft_team_sync(team, G);
    int s_log = 0;  // log2 of the stride
    for (int left = lg >> 1; left > 0;) {
        float vr[4][4], vi[4][4];
        if (left >= 2) {
            // stages s and 4 s: group j = q + s p'; stage-s butterfly u is
            // b_u = j + u n / 16, stage-4s butterfly k is q + s k + 4 s p'
            const int q = j & ((1 << s_log) - 1);
            const int ps = j - q;  // s p'
            if (active) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int idx = fft_swz(j + u * sixteenth + k * quarter);
                        vr[u][k] = re[idx];
                        vi[u][k] = im[idx];
                    }
                }
            }
            fft_team_sync(team, G);  // every read of the trip is done: write in place
            if (active) {
#pragma unroll
                for (int u = 0; u < 4; ++u) fft_bfly4(vr[u], vi[u], ps + u * sixteenth, s);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    float br[4], bi[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        br[u] = vr[u][k];
                        bi[u] = vi[u][k];
                    }
                    fft_bfly4(br, bi, 4 * ps, s);
#pragma unroll
                    for (int k3 = 0; k3 < 4; ++k3) {
                        const int idx = fft_swz(q + (k << s_log) + 16 * ps + (k3 << (s_log + 2)));
                        re[idx] = br[k3];
                        im[idx] = bi[k3];
                    }
                }
            }
            s_log += 4;
            left -= 2;
        } else {
            // one stage alone: butterflies b = j + u G, u < 4
            if (active) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int idx = fft_swz(j + u * G + k * quarter);
                        vr[u][k] = re[idx];
                        vi[u][k] = im[idx];
                    }
                }
            }
            fft_team_sync(team, G);
            if (active) {
                const int smask = (1 << s_log) - 1;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int b = j + u * G;
                    const int q = b & smask;
                    fft_bfly4(vr[u], vi[u], b - q, s);
                    const int o = 4 * b - 3 * q;
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int idx = fft_swz(o + (k << s_log));
                        re[idx] = vr[u][k];
                        im[idx] = vi[u][k];
                    }
                }
            }
            s_log += 2;
            left -= 1;
        }
        fft_team_sync(team, G);
    }
    if (lg & 1) {  // the radix-2 stage, stride n / 2: no twiddle
        if (active) {
            for (int b = j; b < half; b += G) {
                const int i0 = fft_swz(b), i1 = fft_swz(b + half);
                const float ar = re[i0], ai = im[i0], cr = re[i1], ci = im[i1];
                re[i0] = __fadd_rn(ar, cr);
                im[i0] = __fadd_rn(ai, ci);
                re[i1] = __fsub_rn(ar, cr);
                im[i1] = __fsub_rn(ai, ci);
            }
        }
        fft_team_sync(team, G);
    }
}

// The length-R DFT (e^{-2 pi i j k / R}) of (r[k], i[k]), k < R, in place, in
// the float32 operations of frames_fft._dft.
template <int R>
__device__ __forceinline__ void fft_dft(float (&r)[R], float (&i)[R]) {
    if constexpr (R == 2) {
        const float ar = r[0], ai = i[0];
        r[0] = __fadd_rn(ar, r[1]);
        i[0] = __fadd_rn(ai, i[1]);
        r[1] = __fsub_rn(ar, r[1]);
        i[1] = __fsub_rn(ai, i[1]);
    } else if constexpr (R == 4) {
        const float apc_r = __fadd_rn(r[0], r[2]), apc_i = __fadd_rn(i[0], i[2]);
        const float amc_r = __fsub_rn(r[0], r[2]), amc_i = __fsub_rn(i[0], i[2]);
        const float bpd_r = __fadd_rn(r[1], r[3]), bpd_i = __fadd_rn(i[1], i[3]);
        const float bmd_r = __fsub_rn(r[1], r[3]), bmd_i = __fsub_rn(i[1], i[3]);
        // -i (b - d) = (bmd_i, -bmd_r)
        r[0] = __fadd_rn(apc_r, bpd_r);
        i[0] = __fadd_rn(apc_i, bpd_i);
        r[1] = __fadd_rn(amc_r, bmd_i);
        i[1] = __fsub_rn(amc_i, bmd_r);
        r[2] = __fsub_rn(apc_r, bpd_r);
        i[2] = __fsub_rn(apc_i, bpd_i);
        r[3] = __fsub_rn(amc_r, bmd_i);
        i[3] = __fadd_rn(amc_i, bmd_r);
    } else if constexpr (R == 3) {
        // y0 = x0 + t, y1,2 = (x0 - t / 2) -+ i sin(pi/3) (x1 - x2), t = x1 + x2
        const float tr = __fadd_rn(r[1], r[2]), ti = __fadd_rn(i[1], i[2]);
        const float ar = __fsub_rn(r[0], __fmul_rn(tr, 0.5f)), ai = __fsub_rn(i[0], __fmul_rn(ti, 0.5f));
        const float br = __fmul_rn(__fsub_rn(r[1], r[2]), kR3S), bi = __fmul_rn(__fsub_rn(i[1], i[2]), kR3S);
        r[0] = __fadd_rn(r[0], tr);
        i[0] = __fadd_rn(i[0], ti);
        r[1] = __fadd_rn(ar, bi);
        i[1] = __fsub_rn(ai, br);
        r[2] = __fsub_rn(ar, bi);
        i[2] = __fadd_rn(ai, br);
    } else if constexpr (R == 7) {
        // s_k = x_k + x_7-k, d_k = x_k - x_7-k (k = 1, 2, 3); y0 = ((x0 + s1) + s2) + s3;
        // a_m = ((x0 + s1 cos(2 pi m / 7)) + s2 cos(4 pi m / 7)) + s3 cos(6 pi m / 7),
        // b_m = (d1 sin(2 pi m / 7) + d2 sin(4 pi m / 7)) + d3 sin(6 pi m / 7), each
        // term with one of the six constants (a negative sine subtracts it);
        // y_m = a_m - i b_m, y_7-m = a_m + i b_m (frames_fft._dft7)
        float sr[3], si[3], dr[3], di[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            sr[k] = __fadd_rn(r[k + 1], r[6 - k]);
            si[k] = __fadd_rn(i[k + 1], i[6 - k]);
            dr[k] = __fsub_rn(r[k + 1], r[6 - k]);
            di[k] = __fsub_rn(i[k + 1], i[6 - k]);
        }
        const float x0r = r[0], x0i = i[0];
        r[0] = __fadd_rn(__fadd_rn(__fadd_rn(x0r, sr[0]), sr[1]), sr[2]);
        i[0] = __fadd_rn(__fadd_rn(__fadd_rn(x0i, si[0]), si[1]), si[2]);
        auto cosine = [&](float c1, float c2, float c3, float& ar, float& ai) {
            ar = __fadd_rn(__fadd_rn(__fadd_rn(x0r, __fmul_rn(sr[0], c1)), __fmul_rn(sr[1], c2)),
                           __fmul_rn(sr[2], c3));
            ai = __fadd_rn(__fadd_rn(__fadd_rn(x0i, __fmul_rn(si[0], c1)), __fmul_rn(si[1], c2)),
                           __fmul_rn(si[2], c3));
        };
        auto out = [&](int m, float ar, float ai, float br, float bi) {
            r[m] = __fadd_rn(ar, bi);
            i[m] = __fsub_rn(ai, br);
            r[7 - m] = __fsub_rn(ar, bi);
            i[7 - m] = __fadd_rn(ai, br);
        };
        float ar, ai, br, bi;
        // m = 1: sines s1, s2, s3
        cosine(kR7C1, kR7C2, kR7C3, ar, ai);
        br = __fadd_rn(__fadd_rn(__fmul_rn(dr[0], kR7S1), __fmul_rn(dr[1], kR7S2)), __fmul_rn(dr[2], kR7S3));
        bi = __fadd_rn(__fadd_rn(__fmul_rn(di[0], kR7S1), __fmul_rn(di[1], kR7S2)), __fmul_rn(di[2], kR7S3));
        out(1, ar, ai, br, bi);
        // m = 2: sines s2, -s3, -s1
        cosine(kR7C2, kR7C3, kR7C1, ar, ai);
        br = __fsub_rn(__fsub_rn(__fmul_rn(dr[0], kR7S2), __fmul_rn(dr[1], kR7S3)), __fmul_rn(dr[2], kR7S1));
        bi = __fsub_rn(__fsub_rn(__fmul_rn(di[0], kR7S2), __fmul_rn(di[1], kR7S3)), __fmul_rn(di[2], kR7S1));
        out(2, ar, ai, br, bi);
        // m = 3: sines s3, -s1, s2
        cosine(kR7C3, kR7C1, kR7C2, ar, ai);
        br = __fadd_rn(__fsub_rn(__fmul_rn(dr[0], kR7S3), __fmul_rn(dr[1], kR7S1)), __fmul_rn(dr[2], kR7S2));
        bi = __fadd_rn(__fsub_rn(__fmul_rn(di[0], kR7S3), __fmul_rn(di[1], kR7S1)), __fmul_rn(di[2], kR7S2));
        out(3, ar, ai, br, bi);
    } else {
        static_assert(R == 5, "radix 2, 3, 4, 5 or 7");
        const float s1r = __fadd_rn(r[1], r[4]), s1i = __fadd_rn(i[1], i[4]);
        const float d1r = __fsub_rn(r[1], r[4]), d1i = __fsub_rn(i[1], i[4]);
        const float s2r = __fadd_rn(r[2], r[3]), s2i = __fadd_rn(i[2], i[3]);
        const float d2r = __fsub_rn(r[2], r[3]), d2i = __fsub_rn(i[2], i[3]);
        const float a1r = __fadd_rn(__fadd_rn(r[0], __fmul_rn(s1r, kR5C1)), __fmul_rn(s2r, kR5C2));
        const float a1i = __fadd_rn(__fadd_rn(i[0], __fmul_rn(s1i, kR5C1)), __fmul_rn(s2i, kR5C2));
        const float a2r = __fadd_rn(__fadd_rn(r[0], __fmul_rn(s1r, kR5C2)), __fmul_rn(s2r, kR5C1));
        const float a2i = __fadd_rn(__fadd_rn(i[0], __fmul_rn(s1i, kR5C2)), __fmul_rn(s2i, kR5C1));
        const float b1r = __fadd_rn(__fmul_rn(d1r, kR5S1), __fmul_rn(d2r, kR5S2));
        const float b1i = __fadd_rn(__fmul_rn(d1i, kR5S1), __fmul_rn(d2i, kR5S2));
        const float b2r = __fsub_rn(__fmul_rn(d1r, kR5S2), __fmul_rn(d2r, kR5S1));
        const float b2i = __fsub_rn(__fmul_rn(d1i, kR5S2), __fmul_rn(d2i, kR5S1));
        // y1,4 = a1 -+ i b1, y2,3 = a2 -+ i b2
        r[0] = __fadd_rn(__fadd_rn(r[0], s1r), s2r);
        i[0] = __fadd_rn(__fadd_rn(i[0], s1i), s2i);
        r[1] = __fadd_rn(a1r, b1i);
        i[1] = __fsub_rn(a1i, b1r);
        r[2] = __fadd_rn(a2r, b2i);
        i[2] = __fsub_rn(a2i, b2r);
        r[3] = __fsub_rn(a2r, b2i);
        i[3] = __fadd_rn(a2i, b2r);
        r[4] = __fsub_rn(a1r, b1i);
        i[4] = __fadd_rn(a1i, b1r);
    }
}

// One mixed-radix stage of radix R and stride s (see the note above): every
// butterfly b < n / R of the team reads (sr, si) at b + k n / R and writes
// (dr, di) at R (b - q) + q + s k (q = b mod s), outputs 1 .. R - 1 turned;
// the last stage (b - q = 0) turns nothing and writes where it reads, so it
// may run in place.  A butterfly at a time; no barrier (the caller's).
template <int R>
__device__ __forceinline__ void fft_smooth_stage(const float* sr, const float* si, float* dr, float* di, int n,
                                                 int s, bool last, int j, int G, const FftSmem& sm) {
    const int nb = n / R;
    for (int b = j; b < nb; b += G) {
        float vr[R], vi[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            vr[k] = sr[b + k * nb];
            vi[k] = si[b + k * nb];
        }
        fft_dft<R>(vr, vi);
        if (last) {
#pragma unroll
            for (int k = 0; k < R; ++k) {
                dr[b + k * nb] = vr[k];
                di[b + k * nb] = vi[k];
            }
        } else {
            const int q = b % s;
            const int tq = b - q;
#pragma unroll
            for (int k = 1; k < R; ++k) {
                const float wr = sm.twr[k * tq], wi = sm.twi[k * tq];
                const float ur = vr[k], ui = vi[k];
                vr[k] = __fsub_rn(__fmul_rn(ur, wr), __fmul_rn(ui, wi));
                vi[k] = __fadd_rn(__fmul_rn(ur, wi), __fmul_rn(ui, wr));
            }
            const int o = R * tq + q;
#pragma unroll
            for (int k = 0; k < R; ++k) {
                dr[o + k * s] = vr[k];
                di[o + k * s] = vi[k];
            }
        }
    }
}

// The stages run between the team's two halves, (re, im) and (re2, im2), a
// team barrier after each; the last one in place when the others are even
// in number, so that the result always lands in (re, im), where the stages
// started (as the power-of-two route's in-place passes leave it).
struct FftPingPong {
    float *cr, *ci, *nr, *ni;
    int st, n_st, stride;
};

template <int R>
__device__ __forceinline__ void fft_smooth_step(FftPingPong& pp, const FftTeam& t, bool active, int n,
                                                const FftSmem& s) {
    const bool last = pp.st == pp.n_st - 1;
    const bool in_place = last && (pp.n_st - 1) % 2 == 0;
    if (active) {
        fft_smooth_stage<R>(pp.cr, pp.ci, in_place ? pp.cr : pp.nr, in_place ? pp.ci : pp.ni, n, pp.stride, last,
                            t.j, t.G, s);
    }
    if (!in_place) {
        float* r = pp.cr;
        float* i = pp.ci;
        pp.cr = pp.nr;
        pp.ci = pp.ni;
        pp.nr = r;
        pp.ni = i;
    }
    fft_team_sync(t.team, t.G);
    ++pp.st;
    pp.stride *= R;
}

// The mixed-radix forward complex FFT of the team's buffer (re, im), natural
// order, the result in (re, im); barriers as fft_passes'.  kSeven: with the
// radix-7 stages (the instances that take a factor 7); without, n must have
// none.
template <bool kSeven = false>
__device__ __forceinline__ void fft_passes_smooth(const FftTeam& t, bool active, int n, const FftSmem& s) {
    const FftPlan p = fft_smooth_plan<kSeven>(n);
    FftPingPong pp = {t.re, t.im, t.im + n, t.im + 2 * n, 0, p.n7 + p.n5 + p.n3 + p.n4 + p.n2, 1};
    fft_team_sync(t.team, t.G);
    if constexpr (kSeven) {
        for (int i = 0; i < p.n7; ++i) fft_smooth_step<7>(pp, t, active, n, s);
    }
    for (int i = 0; i < p.n5; ++i) fft_smooth_step<5>(pp, t, active, n, s);
    for (int i = 0; i < p.n3; ++i) fft_smooth_step<3>(pp, t, active, n, s);
    for (int i = 0; i < p.n4; ++i) fft_smooth_step<4>(pp, t, active, n, s);
    if (p.n2) fft_smooth_step<2>(pp, t, active, n, s);
}

template <bool kSmooth, bool kSeven = false>
__device__ __forceinline__ void fft_passes_of(const FftTeam& t, bool active, int n, const FftSmem& s) {
    if constexpr (kSmooth) {
        fft_passes_smooth<kSeven>(t, active, n, s);
    } else {
        fft_passes(t, active, n, s);
    }
}

// The two real spectra at bin k of the FFT Z of a pair in the team's buffer:
// X_0[k] = (Z[k] + conj Z[n-k]) / 2, X_1[k] = (Z[k] - conj Z[n-k]) / 2i.
template <bool kSmooth = false>
__device__ __forceinline__ void fft_split(const FftTeam& t, int k, int n, float& ar, float& ai,
                                          float& br, float& bi) {
    const int ia = fft_idx<kSmooth>(k);
    const int ib = kSmooth ? (k == 0 ? 0 : n - k) : fft_swz((n - k) & (n - 1));
    const float a = t.re[ia], b = t.im[ia], c = t.re[ib], d = t.im[ib];
    ar = __fmul_rn(__fadd_rn(a, c), 0.5f);
    ai = __fmul_rn(__fsub_rn(b, d), 0.5f);
    br = __fmul_rn(__fadd_rn(b, d), 0.5f);
    bi = __fmul_rn(__fsub_rn(c, a), 0.5f);
}

// The windowed real DFT of frames r < n_frames, frame r = xs[r hop, r hop + n),
// with `teams` pairs at a time (1 <= teams <= fft_max_teams(n)); emit(r, k, re,
// im) for every k <= n / 2.  Frames r and r + stride share an FFT: pair p is
// frames 2 stride (p / stride) + p mod stride and stride more, a partner at or
// past n_frames a zero frame (stride 1: frames 2p and 2p + 1).  The window and
// the twiddles must have been staged into s (fft_stage) and the samples
// written to xs before the call: it starts with a barrier.  It ends with one,
// so what emit wrote to shared memory is readable on return.
// kSmooth: the mixed-radix route (fft_covers_smooth(n)), twiddles staged by
// fft_stage<true> into an area carved by carve_fft<true>; with kSeven
// (fft_covers_smooth7(n)) the radix-7 stages too, the area carved and staged
// by carve_fft<true, true> / fft_stage<true, true>.
template <bool kSmooth = false, bool kSeven = false, typename Emit>
__device__ void frames_rfft(const float* xs, int n_frames, int hop, int n, FftSmem s, int teams,
                            Emit emit, int stride = 1) {
    __syncthreads();
    const FftTeam t = fft_team<kSmooth>(s, n, teams);
    const int half = n >> 1;
    const int n_pairs = ((n_frames - 1) / (2 * stride) + 1) * stride;
    const int n_rounds = (n_pairs + teams - 1) / teams;
    for (int round = 0; round < n_rounds; ++round) {
        const int p = round * teams + t.team;
        const int g = p / stride;
        const int r0 = 2 * stride * g + (p - g * stride);
        const int r1 = r0 + stride;
        const bool active = t.has_team && p < n_pairs && r0 < n_frames;
        const bool two = r1 < n_frames;
        if (active) fft_load_pair<kSmooth>(t, xs + (size_t)r0 * hop, xs + (size_t)r1 * hop, two, n, s);
        fft_passes_of<kSmooth, kSeven>(t, active, n, s);
        if (active) {  // split the pair
            for (int k = t.j; k <= half; k += t.G) {
                float ar, ai, br, bi;
                fft_split<kSmooth>(t, k, n, ar, ai, br, bi);
                emit(r0, k, ar, ai);
                if (two) emit(r1, k, br, bi);
            }
        }
        fft_team_sync(t.team, t.G);  // the buffer is free for the next round
    }
    __syncthreads();
}

// What frames_irfft and frames_roundtrip share: frames r < n_frames, frame r
// and r + stride through one inverse FFT (pairs as frames_rfft's), the pairs
// of class c = r mod stride before those of class c + 1, a block barrier
// between classes.  Per pair: prep(team, active, r0, r1, two) (frames_roundtrip:
// the pair's forward FFT into the buffer); the packed spectrum from
// spec(team, r0, r1, two, k, ar, ai, br, bi), k <= n / 2, written to the
// buffer as conj Z (Z[k] = X_0[k] + i X_1[k] over k < n, X[n - k] = conj X[k],
// the imaginary parts at DC and nyquist dropped); the forward passes; then
// emit(r, i, v) of both frames' samples v = wsyn[i] Re / Im of conj(FFT(conj
// Z)).  spec may read the buffer at k and n - k: the thread that packs bin k
// writes exactly those two places.
template <bool kSmooth = false, bool kSeven = false, typename Prep, typename Spec, typename Emit>
__device__ void frames_irfft_classes(int n_frames, int stride, int n, const FftSmem& s,
                                     const float* wsyn, int teams, Prep prep, Spec spec,
                                     Emit emit) {
    __syncthreads();
    const FftTeam t = fft_team<kSmooth>(s, n, teams);
    const int half = n >> 1;
    for (int c = 0; c < stride; ++c) {
        const int n_pairs = c < n_frames ? (n_frames - 1 - c) / (2 * stride) + 1 : 0;
        const int n_rounds = (n_pairs + teams - 1) / teams;
        for (int round = 0; round < n_rounds; ++round) {
            const int g = round * teams + t.team;
            const int r0 = 2 * stride * g + c;
            const int r1 = r0 + stride;
            const bool active = t.has_team && g < n_pairs;
            const bool two = r1 < n_frames;
            prep(t, active, r0, r1, two);
            if (active) {
                for (int k = t.j; k <= half; k += t.G) {
                    float ar, ai, br, bi;
                    spec(t, r0, r1, two, k, ar, ai, br, bi);
                    const int ia = fft_idx<kSmooth>(k);
                    if (k == 0 || k == half) {
                        t.re[ia] = ar;
                        t.im[ia] = -br;
                    } else {
                        const int ib = fft_idx<kSmooth>(n - k);
                        t.re[ia] = __fsub_rn(ar, bi);
                        t.im[ia] = -__fadd_rn(ai, br);
                        t.re[ib] = __fadd_rn(ar, bi);
                        t.im[ib] = __fsub_rn(ai, br);
                    }
                }
            }
            fft_passes_of<kSmooth, kSeven>(t, active, n, s);
            if (active) {
                for (int i = t.j; i < n; i += t.G) {
                    const int idx = fft_idx<kSmooth>(i);
                    const float w = wsyn[i];
                    emit(r0, i, __fmul_rn(w, t.re[idx]));
                    if (two) emit(r1, i, -__fmul_rn(w, t.im[idx]));
                }
            }
            fft_team_sync(t.team, t.G);  // the buffer is free for the next round
        }
        __syncthreads();  // this class's emits are done before the next class's
    }
}

// The windowed inverse real DFT of frames r < n_frames whose spectra the
// caller supplies: load(r, k, re, im) for k <= n / 2 (the imaginary parts at
// DC and nyquist are not used), emit(r, i, v) for i < n with
//   v = wsyn[i] sum_k c_k Re(X_r[k] e^{2 pi i k i / n}),  c_0 = c_{n/2} = 1, c_k = 2,
// so wsyn holds the synthesis window over n (ops/cuda/frames_fft.py:
// irfft_window).  Frames r and r + stride share an FFT; with stride = n / hop
// the frames of one class r mod stride do not overlap, so emit may add each
// into a sample buffer with no atomics, and each sample collects its terms in
// class order.  The twiddles must have been staged into s and wsyn (n floats of
// shared memory) written before the call: it starts with a barrier, and ends
// with one.  kSmooth: the mixed-radix route (fft_covers_smooth(n)), twiddles
// staged by fft_stage<true> into an area carved by carve_fft<true>, and wsyn
// from irfft_window(..., smooth=True); kSeven as frames_rfft's.
template <bool kSmooth = false, bool kSeven = false, typename Load, typename Emit>
__device__ void frames_irfft(int n_frames, int stride, int n, FftSmem s, const float* wsyn,
                             int teams, Load load, Emit emit) {
    frames_irfft_classes<kSmooth, kSeven>(
        n_frames, stride, n, s, wsyn, teams, [](const FftTeam&, bool, int, int, bool) {},
        [&](const FftTeam&, int r0, int r1, bool two, int k, float& ar, float& ai, float& br,
            float& bi) {
            load(r0, k, ar, ai);
            br = 0.0f;
            bi = 0.0f;
            if (two) load(r1, k, br, bi);
        },
        emit);
}

// frames_rfft then frames_irfft of the same frames with no spectrum leaving
// the team's buffer: frame r = xs[r hop, r hop + n) under s.win, its bins
// handed to modify(r, k, re, im), which may change them in place, then
// synthesized under wsyn and handed to emit(r, i, v) in class order.  The
// pairs are frames_rfft's with this stride, so the plain version is
// frames_rfft_reference and frames_irfft_reference with it.  Barriers as
// frames_irfft's; xs written before the call.  kSeven as frames_rfft's.
template <bool kSmooth = false, bool kSeven = false, typename Modify, typename Emit>
__device__ void frames_roundtrip(const float* xs, int n_frames, int hop, int n, FftSmem s,
                                 const float* wsyn, int stride, int teams, Modify modify,
                                 Emit emit) {
    frames_irfft_classes<kSmooth, kSeven>(
        n_frames, stride, n, s, wsyn, teams,
        [&](const FftTeam& t, bool active, int r0, int r1, bool two) {
            if (active) fft_load_pair<kSmooth>(t, xs + (size_t)r0 * hop, xs + (size_t)r1 * hop, two, n, s);
            fft_passes_of<kSmooth, kSeven>(t, active, n, s);
        },
        [&](const FftTeam& t, int r0, int r1, bool two, int k, float& ar, float& ai, float& br,
            float& bi) {
            fft_split<kSmooth>(t, k, n, ar, ai, br, bi);
            modify(r0, k, ar, ai);
            if (two) {
                modify(r1, k, br, bi);
            } else {
                br = 0.0f;
                bi = 0.0f;
            }
        },
        emit);
}

}  // namespace att
