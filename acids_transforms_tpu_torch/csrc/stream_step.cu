// Whole-session streaming kernels of [OverlapAdd, RealtimeSTFT-family] chains
// for Hopper (sm_90a).
//
// Replaces, from the JAX package's ops/pallas/stream_step.py:
//   session_encode_kernel<false>     <- _session_forward_kernel        (make_fused_forward_session)
//   session_encode_kernel<true>      <- _analyze_mag, the analysis of _session_pghi_kernel
//                                       (make_fused_pghi_roundtrip; pghi.cu holds its recurrence)
//   session_roundtrip_fft_kernel<0>, session_roundtrip_kernel<., 0>
//                                    <- _session_kernel                (make_fused_roundtrip)
//   session_roundtrip_fft_kernel<1>, session_roundtrip_kernel<., 1>
//                                    <- _session_random_kernel         (make_fused_random_roundtrip)
//   (the encodes' and the roundtrips' kSmooth instances: the same four on the
//   mixed-radix route, where fft_covers_smooth(n_fft): 1200, 960, 768, ...;
//   their kSeven instances, with a radix-7 stage, where fft_covers_smooth7(n_fft)
//   and n_fft has a factor 7: 896, 1344, 1680, ...; the decodes' kSmooth and
//   kSeven instances likewise, session_decode_fft_kernel<., true[, true]> below)
//   session_decode_kernel<., false>  <- _session_random_invert_kernel  (make_fused_random_invert;
//                                       also the synthesis of the RT-PGHI sessions N and Q, with
//                                       the recurrence's phases as its angles)
//   session_decode_kernel<., true>   <- _session_complex_invert_kernel (make_fused_complex_invert)
//   session_decode_fft_kernel<false / true>
//                                    <- the same two (and O's projection synthesis) where
//                                       n_fft is a power of two from 64 to 4096 (the FFT route);
//                                       its kSmooth instances where fft_covers_smooth(n_fft),
//                                       its kSeven instances where fft_covers_smooth7(n_fft)
//                                       and n_fft has a factor 7
//   gl_polish_fft_kernel<., ., .>    <- the Griffin-Lim polish of _session_pghi_gl_kernel (O):
//                                       every projection of a chunk in one launch, where n_fft
//                                       is a power of two from 64 to 4096 (kSmooth = false),
//                                       fft_covers_smooth(n_fft) (kSmooth) or fft_covers_smooth7(n_fft)
//                                       with a factor 7 (kSeven), and the grid fits
//   gl_project_analysis_fft_kernel<., .>
//                                    <- the projection of _session_pghi_gl_kernel (O), its
//                                       analysis and atan2, where the polish's block cannot hold
//                                       the grid, on the FFT and smooth routes (the encode's);
//   gl_project_analysis_kernel       <- the same on the product route (n_fft neither a power of
//                                       two nor 7-smooth); with the decode's kernel of its route
//                                       as its synthesis; pghi.cu's recurrence (seeded) is O's
//                                       seed: make_fused_pghi_gl_roundtrip / _invert
//
// What they compute.  A fresh session's frames are the contiguous slices
// [t hop, t hop + n_fft) of the row-padded signal: (overlap - 1) hop zero
// samples of initial ring, the signal, zeros to the end (frame t < n_frames).
// Its output is the plain overlap-add of all synthesis frames at hop stride,
// cut at n_frames hop samples: output chunk j (hop samples) is the sum of
// piece i of frame j - i over i < overlap, frames before 0 are zero (the
// initial OLA tail) and frames past the last are dropped.  So the carried ring
// and OLA tail of the chunked loop are gone: blocks over (stream, tile of
// output chunks) are independent.  The TPU kernels walk the chunks in a
// sequential grid and carry the OLA tail in scratch; here a block recomputes
// the overlap - 1 frames before its tile instead (its halo).
//
// Encode: every frame's windowed DFT, written as interleaved (re, im), so the
// caller views the output as complex with no copy; the magnitude encode writes
// |X| = sqrt(re^2 + im^2) instead (float32, no complex pass).  Where
// fft_covers(n_fft) (a power of two from 64 to 4096) the encode computes the
// DFT with fft_smem.cuh:frames_rfft (the FFT route); other shapes keep the
// product below (the product route); where fft_covers_smooth(n_fft) (even,
// 2^a 3^b 5^c, 64 to 4096, no power of two) with frames_rfft's mixed-radix
// instance (the smooth route: session_encode_kernel<., true, true>), and where
// n_fft is even, 2^a 3^b 5^c 7^d with a factor 7 (fft_covers_smooth7: 896, 1344,
// 1680, ...) with its radix-7 instance (session_encode_kernel<., true, true,
// true>).  The roundtrips likewise: where fft_covers(n_fft), or on the smooth
// route where fft_covers_smooth7(n_fft) and the block fits (the radix-7
// instance session_roundtrip_fft_kernel<., true, true> where n_fft has a
// factor 7), fft_smem.cuh:frames_roundtrip (each frame pair's
// forward FFT, its bins, its inverse FFT in one team's buffer, the synthesis
// overlap-added into the block's output chunks in class order); elsewhere the
// products: the analysis of the R + overlap - 1 frames that cover a block's R
// output chunks into [re | im] rows in shared memory (for the random mode: |X| times (cos, sin)
// of the session's angles, read in), then the synthesis product of
// synth_ola.cuh over those rows, with the synthesis window and the 1 / gain of
// OverlapAdd folded into its basis.  Decode: the rows are mag * (cos, sin)
// (angle) of the input, then the same synthesis; where fft_covers(n_fft),
// fft_smem.cuh:frames_irfft of the input spectra instead (the FFT route:
// session_decode_fft_kernel, the synthesis half of the roundtrips' FFT route,
// sincosf and two products a bin, no basis), and on the smooth route where
// fft_covers_smooth(n_fft) its mixed-radix instance
// (session_decode_fft_kernel<., true>), or where n_fft has a factor 7
// (fft_covers_smooth7) its radix-7 instance (session_decode_fft_kernel<.,
// true, true>).
//
// What bounds them on this card: the functions are bound by bytes (an FFT
// per frame is 2.5 n_fft log2 n_fft operations, far below the fp32 ridge of
// 20 flop per byte).  The product route is not: it keeps the TPU kernels'
// full-length products, n_fft * F multiply-adds per frame and direction (cos
// and sin), about 1 M at n_fft 1024, so its own ceiling is the card's fp32 FMA
// rate.  The FFT routes of the encode and the roundtrips do an FFT's
// operations and read no basis (fft_smem.cuh); at 1024/256 a roundtrip block
// of 24 output chunks (32 frames, 4 FFTs side by side) takes 108 KB, so two
// share an SM.
//
// Design of the product route.  The analysis is the full-K product of
// dft_common.cuh for every window (the DGT's gaussian has no cosine taps, and
// one design covers both RealtimeSTFT and RealtimeDGT), written with its own
// epilogue: a block's frames (at most 40) are rows of a shared-memory sample
// buffer at stride hop, 128-bin column tiles, the window-folded basis (n_fft
// rounded up to 32 rows, zero rows below) staged through shared memory 32 rows
// ahead of the multiply-adds, a thread's 5 rows x 4 bins x (re, im) in
// registers, summed in partial sums of 128 terms (kSumFold below; the
// synthesis likewise).  The encode stores its sums straight to device memory;
// the roundtrip into the [re | im] rows of the synthesis (row stride Kp, zero
// columns 2F .. Kp).  At n_fft 1200, hop 300 a roundtrip block owns 24 chunks:
// samples 36 KB, rows of 27 frames 131 KB, staging 32 KB, one block of 8 warps
// per SM.  Samples are read from the signal with bounds checks (the zero ring
// and tail are never materialized).  Arithmetic is fp32 FMA with fp32
// accumulation; sincosf is the full-range function (no --use_fast_math).
//
// O (the pghi_gl sessions) is serial across chunks: chunk c + 1's seed and
// pinned context are chunk c's polished phases, so no whole-session launch
// can run it.  Its wrapper walks the chunks on the host, each chunk over the
// whole batch of sessions: one seeded recurrence launch (pghi.cu), then the
// polish of the extended grid of gl_context + T_c + lookahead frames (and
// overlap - 1 zero frames).  Within a chunk the iterations do not depend on
// the host (the pinned and frozen rows are fixed for the chunk) and the
// sessions are independent, so where n_fft is a power of two from 64 to 4096
// or fft_covers_smooth7(n_fft) and the block holds the grid, the polish is one
// launch, gl_polish_fft_kernel (kSmooth: its mixed-radix instance, kSeven its
// radix-7 one): a block per session runs
// every iteration with the grid's overlap-add signal (and, where it fits, the
// grid's magnitudes and phases) in shared memory, as the TPU kernel runs its
// iterations in VMEM.  Elsewhere each iteration is two launches: P's synthesis
// into the grid's overlap-add signal in device memory (narrow blocks, so that
// a session fills several SMs) and the analysis: on the FFT and smooth routes
// gl_project_analysis_fft_kernel (blocks of a session's even group of frames,
// frames_rfft with the polish's pairs, so that iters two-launch projections
// are the polish to the bit), on the product route gl_project_analysis_kernel
// (blocks of one session and one 128-bin tile).  The commit and the carries are a few small
// tensor operations, and P's synthesis of every committed frame ends the
// session.  The phases of the grid stay in one device array that the polish
// updates in place.
#include <math.h>

#include "dft_common.cuh"
#include "fft_smem.cuh"
#include "synth_ola.cuh"

namespace att {

constexpr int kStageFloats = 2 * kKC * kColTile;  // == kSynKC * kSynCols: one area for both phases
// Partial sums: both products add up long runs of terms that cancel, and one
// running sum over them rounds further from exact than the generic scan's
// cuBLAS products (the synthesis there is two products of F terms each).
// Measured on an H100 at 1024/256: one running sum in the synthesis gave the
// complex roundtrip 118.8 dB against the generic scan's 127.3 dB (64
// sessions), partial sums of 256 terms there 127.9 dB; with the analysis still
// one running sum of n_fft terms, RealtimeDGT at 8 sessions reached 127.4 dB
// against 132.1 dB.  So each product sums kSumFold staged chunks of 32 terms
// at a time and adds that partial sum to its total.
constexpr int kSumFold = 4;
static_assert(kStageFloats == kSynKC * kSynCols, "analysis and synthesis share the staging area");

struct SessionArgs {
    const float* x;       // (B, L) signal (encode, roundtrips)
    const float* mag;     // (B, T, F) magnitudes (decode)
    const float* angles;  // (B, Ta, F) session angles (random modes)
    const float* wc;      // (Kn, F) window-folded analysis basis, cos; zero rows past n_fft
    const float* ws;      //                                      -sin
    const float* syn;     // (overlap, Kp, hop) synthesis basis [A; B; 0] * inv_window / gain
    const float* win;     // FFT route: (n_fft,) analysis window
    const float* wsyn;    //            (n_fft,) synthesis window / gain / n_fft (roundtrips)
    const float* fft_tw;  //            (2, n_fft) twiddle table
    float* out;           // encode: (B, T, F, 2); roundtrip: (B, T hop); decode: (B, T hop)
    long long L;
    int T, Ta, F, hop, overlap, Kn, Kp, rows, n_tiles, teams;
};

// xs[i] = padded[p0 + i] for i < n, where padded is (overlap - 1) hop zeros,
// then the signal x_row of L samples, then zeros.  Ends with a barrier.
__device__ void load_session_samples(const float* __restrict__ x_row, long long L, long long p0,
                                     int lead, int n, float* xs) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const long long s = p0 + i - lead;
        xs[i] = (s >= 0 && s < L) ? __ldg(x_row + s) : 0.0f;
    }
    __syncthreads();
}

// Full-K windowed DFT of n_rows <= kMaxRows frames held in shared memory:
// frame r is xs[r hop, r hop + Kn) (samples past n_fft meet zero basis rows).
// emit(r, k, re, im) for every r < n_rows and k < F of the 128-bin column
// tiles ct_begin .. ct_end - 1 (all of them by default).  Starts and ends with
// a barrier, so xs may be written right before and the emitted values read
// right after.
template <typename Emit>
__device__ void fullk_analysis(const float* xs, int n_rows, int hop, int Kn, int F,
                               const float* __restrict__ wc, const float* __restrict__ ws,
                               float* stage, Emit emit, int ct_begin = 0, int ct_end = -1) {
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    constexpr int RPT = kMaxRows / 8;  // rows per thread
    int rows[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
        rows[i] = r < n_rows ? r : n_rows - 1;
    }
    // a warp whose rows all lie past n_rows only helps staging the basis
    const bool warp_active = ty * RPT < n_rows;
    float* Bc = stage;
    float* Bsn = stage + kKC * kColTile;
    constexpr int kRowsPer = kKC * kColTile / kThreads;
    constexpr int kRowStep = kThreads / kColTile;
    const int stage_c = tid % kColTile;
    const int stage_r = tid / kColTile;
    const int n_ct = (F + kColTile - 1) / kColTile;
    const int ct_stop = ct_end < 0 ? n_ct : min(ct_end, n_ct);
    for (int ct = ct_begin; ct < ct_stop; ++ct) {
        const int k_stage = ct * kColTile + stage_c;
        const bool stage_ok = k_stage < F;
        const size_t col = stage_ok ? (size_t)k_stage : 0;
        // totals, and the partial sums of the current kSumFold chunks
        float acc_re[RPT][4], acc_im[RPT][4], part_re[RPT][4], part_im[RPT][4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc_re[i][q] = 0.0f;
                acc_im[i][q] = 0.0f;
                part_re[i][q] = 0.0f;
                part_im[i][q] = 0.0f;
            }
        }
        // a thread stages one basis column over every second row of a chunk;
        // the next chunk is loaded into registers before this one is used
        float vc[kRowsPer], vs[kRowsPer];
        auto fetch = [&](int n0) {
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) {
                const size_t o = (size_t)(n0 + stage_r + i * kRowStep) * F + col;
                vc[i] = __ldg(wc + o);
                vs[i] = __ldg(ws + o);
            }
        };
        fetch(0);
        for (int n0 = 0; n0 < Kn; n0 += kKC) {
            __syncthreads();  // previous chunk (or the caller's samples) done
#pragma unroll
            for (int i = 0; i < kRowsPer; ++i) {
                const int kk = stage_r + i * kRowStep;
                Bc[kk * kColTile + stage_c] = stage_ok ? vc[i] : 0.0f;
                Bsn[kk * kColTile + stage_c] = stage_ok ? vs[i] : 0.0f;
            }
            __syncthreads();
            if (n0 + kKC < Kn) fetch(n0 + kKC);
            if (!warp_active) continue;
            const int done = n0 / kKC + 1;  // chunks summed after this one
#pragma unroll 2
            for (int kk = 0; kk < kKC; kk += 4) {
                float4 a[RPT];
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    a[i] = *reinterpret_cast<const float4*>(xs + (size_t)rows[i] * hop + n0 + kk);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4 bc = *reinterpret_cast<const float4*>(Bc + (kk + u) * kColTile + tx * 4);
                    const float4 bs = *reinterpret_cast<const float4*>(Bsn + (kk + u) * kColTile + tx * 4);
#pragma unroll
                    for (int i = 0; i < RPT; ++i) {
                        const float av = u == 0 ? a[i].x : (u == 1 ? a[i].y : (u == 2 ? a[i].z : a[i].w));
                        part_re[i][0] = fmaf(av, bc.x, part_re[i][0]);
                        part_re[i][1] = fmaf(av, bc.y, part_re[i][1]);
                        part_re[i][2] = fmaf(av, bc.z, part_re[i][2]);
                        part_re[i][3] = fmaf(av, bc.w, part_re[i][3]);
                        part_im[i][0] = fmaf(av, bs.x, part_im[i][0]);
                        part_im[i][1] = fmaf(av, bs.y, part_im[i][1]);
                        part_im[i][2] = fmaf(av, bs.z, part_im[i][2]);
                        part_im[i][3] = fmaf(av, bs.w, part_im[i][3]);
                    }
                }
            }
            if (done % kSumFold == 0 || done * kKC == Kn) {
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc_re[i][q] += part_re[i][q];
                        acc_im[i][q] += part_im[i][q];
                        part_re[i][q] = 0.0f;
                        part_im[i][q] = 0.0f;
                    }
                }
            }
        }
        if (warp_active) {
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = ty * RPT + i;
                if (r >= n_rows) continue;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int k = ct * kColTile + tx * 4 + q;
                    if (k < F) emit(r, k, acc_re[i][q], acc_im[i][q]);
                }
            }
        }
    }
    __syncthreads();
}

__host__ __device__ inline size_t encode_smem_floats(int rows, int hop, int Kn) {
    return (size_t)(rows - 1) * hop + Kn + kStageFloats;
}

// The encode's FFT and smooth routes: the samples of `rows` frames, then
// frames_rfft's area (that of the route n_fft takes).
__host__ __device__ inline size_t encode_fft_smem_floats(int rows, int hop, int n_fft, int teams) {
    return (size_t)(rows - 1) * hop + n_fft + fft_area_floats(n_fft, teams);
}

__host__ __device__ inline size_t roundtrip_smem_floats(int rows, int overlap, int hop, int Kn,
                                                        int Kp) {
    const int n_rows = rows + overlap - 1;
    return (size_t)(n_rows - 1) * hop + Kn + (size_t)n_rows * Kp + kStageFloats;
}

// The roundtrips' FFT and smooth routes: the samples of rows + 2 overlap
// frames, the output chunks, frames_rfft's area (that of the route n takes)
// and the synthesis window.
__host__ __device__ inline size_t roundtrip_fft_smem_floats(int rows, int overlap, int hop,
                                                            int teams) {
    const int n = overlap * hop;
    return (size_t)(rows + 2 * overlap - 1) * hop + n + (size_t)rows * hop + fft_area_floats(n, teams) +
           (size_t)n;
}

__host__ __device__ inline size_t decode_smem_floats(int rows, int overlap, int Kp) {
    return (size_t)(rows + overlap - 1) * Kp + kStageFloats;
}

// R (kMag = false): a block owns `rows` frames t0 .. of one stream.  kMag
// writes the magnitude, each product rounded on its own so that the plain
// version's sqrt(re * re + im * im) repeats it.  kFft: the FFT route
// (frames_rfft over the block's frames, pairs (2j, 2j + 1) of the block, rows
// even, so of the session too), at most 128 registers a thread so that two
// blocks share an SM (79 KB of shared memory each at 1024/256: 32 frames, 4
// FFTs side by side); with kSmooth its mixed-radix instance (74 KB at
// 1200/300: 16 frames, 2 FFTs of 128 threads); with kSeven its radix-7
// instance (fft_covers_smooth7(n_fft), n_fft with a factor 7: 1344 = 7 3 4 4
// 4); otherwise the product route.
template <bool kMag, bool kFft, bool kSmooth = false, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, kFft ? 2 : 1) session_encode_kernel(SessionArgs a) {
    extern __shared__ __align__(16) float smem[];
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int t0 = (int)(blk - b * a.n_tiles) * a.rows;
    const int n_rows = min(a.rows, a.T - t0);
    const int n_fft = a.overlap * a.hop;
    const int klen = kFft ? n_fft : a.Kn;  // samples a frame reads
    float* xs = smem;
    float* work = xs + (size_t)(a.rows - 1) * a.hop + klen;  // 16-byte aligned: hop % 4 == 0
    FftSmem fs = {};
    if constexpr (kFft) {
        fs = carve_fft<kSmooth, kSeven>(work, n_fft);
        fft_stage<kSmooth, kSeven>(a.win, a.fft_tw, fs, n_fft);  // load_session_samples' barrier covers it
    }
    load_session_samples(a.x + (size_t)b * a.L, a.L, (long long)t0 * a.hop,
                         (a.overlap - 1) * a.hop, (n_rows - 1) * a.hop + klen, xs);
    const int F = a.F;
    auto analysis = [&](auto emit) {
        if constexpr (kFft) {
            frames_rfft<kSmooth, kSeven>(xs, n_rows, a.hop, n_fft, fs, a.teams, emit);
        } else {
            fullk_analysis(xs, n_rows, a.hop, a.Kn, F, a.wc, a.ws, work, emit);
        }
    };
    if constexpr (kMag) {
        float* out = a.out + ((size_t)b * a.T + t0) * F;
        analysis([&](int r, int k, float re, float im) {
            out[(size_t)r * F + k] = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
        });
    } else {
        float2* out = reinterpret_cast<float2*>(a.out) + ((size_t)b * a.T + t0) * F;
        analysis([&](int r, int k, float re, float im) { out[(size_t)r * F + k] = make_float2(re, im); });
    }
}

// L (kRandom = false) and M (kRandom = true): a block owns `rows` output
// chunks j0 .. of one stream; S row q is frame j0 - (overlap - 1) + q.
template <int kRPT, bool kRandom>
__global__ void __launch_bounds__(kThreads) session_roundtrip_kernel(SessionArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int m = a.overlap - 1, F = a.F, Kp = a.Kp, hop = a.hop;
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int j0 = (int)(blk - b * a.n_tiles) * a.rows;
    const int j_end = min(a.T, j0 + a.rows);   // output chunks this block stores
    const int n_rows = j_end - j0 + m;         // frames j0 - m .. j_end - 1
    const int n_samples = (n_rows - 1) * hop + a.Kn;
    float* xs = smem;
    float* S = xs + (size_t)(a.rows + m - 1) * hop + a.Kn;  // 16-byte aligned: hop % 4 == 0
    float* stage = S + (size_t)(a.rows + m) * Kp;
    for (int q = 0; q < n_rows; ++q) {  // zero columns 2F .. Kp of every row
        for (int k = 2 * F + threadIdx.x; k < Kp; k += kThreads) S[(size_t)q * Kp + k] = 0.0f;
    }
    load_session_samples(a.x + (size_t)b * a.L, a.L, (long long)(j0 - m) * hop, m * hop, n_samples,
                         xs);
    fullk_analysis(xs, n_rows, hop, a.Kn, F, a.wc, a.ws, stage,
                   [&](int r, int k, float re, float im) {
                       S[(size_t)r * Kp + k] = re;
                       S[(size_t)r * Kp + F + k] = im;
                   });
    if (kRandom) {
        // |X| with the session's angles; frames before 0 are zero rows
        const float* ang = a.angles + (size_t)b * a.Ta * F;
        for (int idx = threadIdx.x; idx < n_rows * F; idx += kThreads) {
            const int q = idx / F;
            const int k = idx - q * F;
            const int f = j0 - m + q;
            float* row = S + (size_t)q * Kp;
            const float re = row[k], im = row[F + k];
            float cs = 0.0f, sn = 0.0f;
            if (f >= 0) sincosf(__ldg(ang + (size_t)f * F + k), &sn, &cs);
            const float mg = sqrtf(re * re + im * im);
            row[k] = mg * cs;
            row[F + k] = mg * sn;
        }
    }
    // synth_ola_tile starts with a barrier before it reads S; it stores the
    // chunks below j_end and clamps the reads of the rows past them
    synth_ola_tile<kRPT, kSumFold>(S, stage, a.syn, Kp, hop, a.overlap, j0, j_end, a.out + (size_t)b * a.T * hop);
}

// L and M on the FFT route (n_fft a power of two from 64 to 4096): a block
// owns `rows` output chunks j0 .. j_end - 1 (rows a multiple of 2 overlap) and
// runs frames_roundtrip over the frames j0 - (overlap - 1) .. : local frame r
// is frame j0 - (overlap - 1) + r, rows + 2 overlap of them at most, paired
// (f, f + overlap) for (f + overlap - 1) mod 2 overlap < overlap (the pairing
// of the whole session, so no frame's rounding depends on its block; the
// frames past the block's last chunk are only partners).  The bins of frames
// before 0 are zero (M: |X| (cos, sin)(angle) of the others), and their
// samples are not added; the others are added into the block's output chunks
// in class order, and the chunks stored.  Two blocks an SM at 1024/256.
// kSmooth: the mixed-radix instance (fft_covers_smooth(n_fft); 16 chunks, 2
// FFTs of 128 threads, 107 KB, two blocks an SM at 1200/300; plan
// frames_fft.class_plan_smooth); with kSeven its radix-7 instance
// (fft_covers_smooth7(n_fft), n_fft with a factor 7).
template <bool kRandom, bool kSmooth = false, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, 2) session_roundtrip_fft_kernel(SessionArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int m = a.overlap - 1, F = a.F, hop = a.hop, ov = a.overlap, T = a.T;
    const int n = ov * hop;
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int j0 = (int)(blk - b * a.n_tiles) * a.rows;
    const int j_end = min(T, j0 + a.rows);
    const int n_frames = min(a.rows + 2 * ov, T + m - j0);
    float* xs = smem;                                            // frames' samples
    float* out = xs + (size_t)(a.rows + 2 * ov - 1) * hop + n;   // [rows][hop]
    const FftSmem fs = carve_fft<kSmooth, kSeven>(out + (size_t)a.rows * hop, n);
    float* wsyn = fs.buf + (size_t)a.teams * fft_buf_floats_of<kSmooth>(n);
    fft_stage<kSmooth, kSeven>(a.win, a.fft_tw, fs, n);
    for (int i = threadIdx.x; i < n; i += kThreads) wsyn[i] = __ldg(a.wsyn + i);
    for (int i = threadIdx.x; i < a.rows * hop; i += kThreads) out[i] = 0.0f;
    // frame f reads x[(f - m) hop, ..): local frame 0 starts 2 m hop before j0 hop
    load_session_samples(a.x + (size_t)b * a.L, a.L, (long long)j0 * hop, 2 * m * hop,
                         (n_frames - 1) * hop + n, xs);
    const int f0 = j0 - m;
    const float* ang = kRandom ? a.angles + (size_t)b * a.Ta * F : nullptr;
    const int n_out = (j_end - j0) * hop;
    frames_roundtrip<kSmooth, kSeven>(
        xs, n_frames, hop, n, fs, wsyn, ov, a.teams,
        [&](int r, int k, float& re, float& im) {
            const int f = f0 + r;
            if (f < 0) {
                re = 0.0f;
                im = 0.0f;
            } else if (kRandom) {
                const float mg = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
                float sn, cs;
                sincosf(__ldg(ang + (size_t)f * F + k), &sn, &cs);
                re = __fmul_rn(mg, cs);
                im = __fmul_rn(mg, sn);
            }
        },
        [&](int r, int i, float v) {
            const int f = f0 + r;
            const int pos = (f - j0) * hop + i;
            if (f >= 0 && pos >= 0 && pos < n_out) out[pos] = __fadd_rn(out[pos], v);
        });
    // frames_roundtrip ends with a barrier
    float* dst = a.out + (size_t)b * T * hop + (size_t)j0 * hop;
    for (int i = threadIdx.x; i < n_out; i += kThreads) dst[i] = out[i];
}

// P (kComplex = false) and S: a block owns `rows` output chunks j0 .. of one
// stream; S row q is frame j0 - (overlap - 1) + q: mag * (cos, sin)(angle) of
// the input, or for S the input's interleaved (re, im) (a.mag is then the
// complex spectrum (B, T, F, 2)).
template <int kRPT, bool kComplex>
__global__ void __launch_bounds__(kThreads) session_decode_kernel(SessionArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int m = a.overlap - 1, F = a.F, Kp = a.Kp, T = a.T;
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int j0 = (int)(blk - b * a.n_tiles) * a.rows;
    const int j_end = min(T, j0 + a.rows);
    const int n_rows = j_end - j0 + m;
    float* S = smem;
    float* stage = S + (size_t)(a.rows + m) * Kp;
    const float* mag = a.mag + (size_t)b * T * F;
    const float2* spec = reinterpret_cast<const float2*>(a.mag) + (size_t)b * T * F;
    const float* ang = kComplex ? nullptr : a.angles + (size_t)b * a.Ta * F;
    for (int q = 0; q < n_rows; ++q) {
        const int f = j0 - m + q;
        float* row = S + (size_t)q * Kp;
        if (f >= 0) {
            for (int k = threadIdx.x; k < F; k += kThreads) {
                if constexpr (kComplex) {
                    const float2 v = __ldg(spec + (size_t)f * F + k);
                    row[k] = v.x;
                    row[F + k] = v.y;
                } else {
                    float sn, cs;
                    sincosf(__ldg(ang + (size_t)f * F + k), &sn, &cs);
                    const float mg = __ldg(mag + (size_t)f * F + k);
                    row[k] = mg * cs;
                    row[F + k] = mg * sn;
                }
            }
            for (int k = 2 * F + threadIdx.x; k < Kp; k += kThreads) row[k] = 0.0f;
        } else {
            for (int k = threadIdx.x; k < Kp; k += kThreads) row[k] = 0.0f;
        }
    }
    synth_ola_tile<kRPT, kSumFold>(S, stage, a.syn, Kp, a.hop, a.overlap, j0, j_end, a.out + (size_t)b * T * a.hop);
}

// The decode's FFT and smooth routes: the rows chunks of output, then
// frames_irfft's area (that of the route n takes), whose window slot holds
// wsyn.
__host__ __device__ inline size_t decode_fft_smem_floats(int rows, int hop, int n, int teams) {
    return (size_t)rows * hop + fft_area_floats(n, teams);
}

// P (kComplex = false), S and O's projection synthesis on the FFT route
// (n_fft a power of two from 64 to 4096): the synthesis half of
// session_roundtrip_fft_kernel, fed from the input spectra.  A block owns
// `rows` output chunks j0 .. j_end - 1 of one stream (rows a multiple of 2
// overlap) and runs frames_irfft over the frames j0 - (overlap - 1) .. (local
// frame r is frame j0 - (overlap - 1) + r, rows + 2 overlap of them at most,
// paired (f, f + overlap) for (f + overlap - 1) mod 2 overlap < overlap: the
// pairing of the whole session, so no frame's rounding depends on its block).
// Frames before 0 load zero bins and add nothing; frame f's bins are mag *
// (cos, sin)(angle) from one full-range sincosf, each product rounded on its
// own, or S's (re, im) as they are (the imaginary parts at DC and nyquist not
// read, as the product basis does not read them).  The frames are added into
// the block's output chunks in class order (f + overlap - 1) mod overlap and
// the chunks stored.  wsyn = the synthesis window / gain / n_fft.
// kSmooth: the mixed-radix instance (fft_covers_smooth(n_fft): frames_irfft's
// mixed-radix stages, twiddles j < fft_smooth_table(n), wsyn with the 1 / n
// fold rounded once from float64; plan stream_step._decode_plan); with
// kSeven its radix-7 instance (fft_covers_smooth7(n_fft), n_fft with a
// factor 7: 1344 = 7 3 4 4 4, 896 = 7 4 4 4 2), the rest alike.
template <bool kComplex, bool kSmooth = false, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, 2) session_decode_fft_kernel(SessionArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int m = a.overlap - 1, F = a.F, hop = a.hop, ov = a.overlap, T = a.T;
    const int n = ov * hop;
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int j0 = (int)(blk - b * a.n_tiles) * a.rows;
    const int j_end = min(T, j0 + a.rows);
    const int n_frames = min(a.rows + 2 * ov, T + m - j0);
    float* out = smem;  // [rows][hop]
    const FftSmem fs = carve_fft<kSmooth, kSeven>(out + (size_t)a.rows * hop, n);
    fft_stage<kSmooth, kSeven>(a.wsyn, a.fft_tw, fs, n);  // wsyn in the window's slot
    for (int i = threadIdx.x; i < a.rows * hop; i += kThreads) out[i] = 0.0f;
    const int f0 = j0 - m;
    const float* mag = a.mag + (size_t)b * T * F;
    const float2* spec = reinterpret_cast<const float2*>(a.mag) + (size_t)b * T * F;
    const float* ang = kComplex ? nullptr : a.angles + (size_t)b * a.Ta * F;
    const int n_out = (j_end - j0) * hop;
    // frames_irfft starts with a barrier and ends with one
    frames_irfft<kSmooth, kSeven>(
        n_frames, ov, n, fs, fs.win, a.teams,
        [&](int r, int k, float& re, float& im) {
            const int f = f0 + r;
            if (f < 0) {
                re = 0.0f;
                im = 0.0f;
            } else if constexpr (kComplex) {
                const float2 v = __ldg(spec + (size_t)f * F + k);
                re = v.x;
                im = v.y;
            } else {
                const float mg = __ldg(mag + (size_t)f * F + k);
                float sn, cs;
                sincosf(__ldg(ang + (size_t)f * F + k), &sn, &cs);
                re = __fmul_rn(mg, cs);
                im = __fmul_rn(mg, sn);
            }
        },
        [&](int r, int i, float v) {
            const int f = f0 + r;
            const int pos = (f - j0) * hop + i;
            if (f >= 0 && pos >= 0 && pos < n_out) out[pos] = __fadd_rn(out[pos], v);
        });
    float* dst = a.out + (size_t)b * T * hop + (size_t)j0 * hop;
    for (int i = threadIdx.x; i < n_out; i += kThreads) dst[i] = out[i];
}

// O's projection, analysis half (the synthesis half is P's kernel with the
// basis divided by overlap instead of the OverlapAdd gain).  y (B, Ly) holds
// each session's overlap-add of its extended grid's frames; grid frame f is
// y[f hop, f hop + n_fft).  Both kernels write phase[b, f, k] = atan2(im, re)
// of every frame f0 .. Tx - 1 (f0 = gl_context: the pinned rows are never
// recomputed) outside [keep_lo, keep_hi), the frozen rows, which keep their
// value.  The product route (gl_project_analysis_kernel, n_fft neither a power
// of two nor 7-smooth): a block owns one session and one 128-bin column tile
// of all those frames (at most 40), the full-K product.
struct GlProjectArgs {
    const float* y;       // (B, Ly)
    const float* wc;      // product route: (Kn, F) window-folded analysis basis, cos; zero rows past n_fft
    const float* ws;      //                                                       -sin
    const float* win;     // FFT and smooth routes: (n_fft,) analysis window
    const float* fft_tw;  //                        (2, n_fft) twiddle table
    float* phase;         // (B, Tp, F), rows f0 .. Tx - 1 updated in place
    long long Ly;
    int Tp, Tx, f0, keep_lo, keep_hi, F, hop, Kn, n_ct;
    int n_fft, rows, teams;  // FFT and smooth routes; n_ct is then the blocks a session
};

__global__ void __launch_bounds__(kThreads) gl_project_analysis_kernel(GlProjectArgs a) {
    extern __shared__ __align__(16) float smem[];
    const long long b = blockIdx.x / a.n_ct;
    const int ct = (int)(blockIdx.x - b * a.n_ct);
    const int n_rows = a.Tx - a.f0;
    float* xs = smem;
    float* stage = xs + (size_t)(n_rows - 1) * a.hop + a.Kn;  // 16-byte aligned: hop % 4 == 0
    load_session_samples(a.y + (size_t)b * a.Ly, a.Ly, (long long)a.f0 * a.hop, 0,
                         (n_rows - 1) * a.hop + a.Kn, xs);
    const int F = a.F;
    float* out = a.phase + ((size_t)b * a.Tp + a.f0) * F;
    const int lo = a.keep_lo - a.f0, hi = a.keep_hi - a.f0;
    fullk_analysis(xs, n_rows, a.hop, a.Kn, F, a.wc, a.ws, stage,
                   [&](int r, int k, float re, float im) {
                       if (r < lo || r >= hi) out[(size_t)r * F + k] = atan2f(im, re);
                   },
                   ct, ct + 1);
}

// The FFT and smooth routes (n_fft a power of two from 64 to 4096, or
// fft_covers_smooth7(n_fft); kSmooth / kSeven as the encode's): the encode's
// FFT-route block on the grid's signal.  A block owns `rows` frames (even) of
// one session, f0 + g rows .. (frame f = y[f hop, f hop + n_fft), no zero
// ring), and runs frames_rfft over them under the analysis window: pairs (2j,
// 2j + 1) counted from f0, the pairs of the polish's analysis, so every bin
// comes out as the polish computes it and one session's frames spread over
// several SMs (5 blocks of 8 frames at 4096/1024 and 40 frames).  The grid's
// length is not bounded by a block: samples are read in by the block's frames.
template <bool kSmooth, bool kSeven>
__global__ void __launch_bounds__(kThreads, 2) gl_project_analysis_fft_kernel(GlProjectArgs a) {
    extern __shared__ __align__(16) float smem[];
    const long long b = blockIdx.x / a.n_ct;
    const int t0 = a.f0 + (int)(blockIdx.x - b * a.n_ct) * a.rows;
    const int n_rows = min(a.rows, a.Tx - t0);
    const int n_fft = a.n_fft, F = a.F;
    float* xs = smem;
    const FftSmem fs = carve_fft<kSmooth, kSeven>(xs + (size_t)(a.rows - 1) * a.hop + n_fft, n_fft);  // 16-byte aligned
    fft_stage<kSmooth, kSeven>(a.win, a.fft_tw, fs, n_fft);  // load_session_samples' barrier covers it
    load_session_samples(a.y + (size_t)b * a.Ly, a.Ly, (long long)t0 * a.hop, 0, (n_rows - 1) * a.hop + n_fft, xs);
    float* out = a.phase + ((size_t)b * a.Tp + t0) * F;
    const int lo = a.keep_lo - t0, hi = a.keep_hi - t0;
    frames_rfft<kSmooth, kSeven>(xs, n_rows, a.hop, n_fft, fs, a.teams, [&](int r, int k, float re, float im) {
        if (r < lo || r >= hi) out[(size_t)r * F + k] = atan2f(im, re);
    });
}

// O's polish on the FFT route (n_fft a power of two from 64 to 4096) and,
// with kSmooth, on the smooth route (fft_covers_smooth(n_fft): frames_irfft's
// and frames_rfft's mixed-radix stages, twiddles j < fft_smooth_table(n), wsyn
// with the 1 / n fold rounded once from float64; with kSeven the radix-7
// instance, fft_covers_smooth7(n_fft) and n_fft with a factor 7): one
// block per session runs all `iters` projections of its grid of Tp = Tx +
// overlap - 1 frames (the last overlap - 1 of zero magnitude).  Each:
// * synthesis: frames_irfft of every grid frame, bins mag * (cos, sin)(phase)
//   from one full-range sincosf, each product rounded on its own, under wsyn
//   (the synthesis window / overlap / n_fft), overlap-added into the grid's
//   signal y (Tp hop samples, shared memory, zeroed first): the decode's FFT
//   route with one block over the whole grid (local frame r is frame r -
//   (overlap - 1), paired (r, r + overlap) for r mod 2 overlap < overlap,
//   frames before 0 zero bins and no samples, class order (f + overlap - 1)
//   mod overlap), so its synthesis is P's to the bit;
// * analysis: frames_rfft of the re-framed rows ctx .. Tx - 1 of y (frame f
//   is y[f hop, f hop + n_fft), pairs (2j, 2j + 1) counted from ctx) under the
//   analysis window, atan2f of each bin written to the grid's phase, except
//   on the frozen rows [keep_lo, keep_hi); the pinned rows < ctx are never
//   written.
// frames_irfft and frames_rfft each start and end with a block barrier, so a
// projection reads the phases the one before wrote.  kResident: the grid's
// magnitudes and phases are read into shared memory once and the polished
// rows written back once; otherwise they stay in device memory, the phases
// read with __ldcg (L2: they are written in the launch) and written in place.
// Bound by its chain of FFT rounds, not by bytes: the function moves the grid
// once (2 Tp F floats in, (Tx - ctx) F out) and does iters x (Tp + Tx - ctx)
// FFTs.  One block per session and __launch_bounds__(256, 1): the block holds
// 160 KB at 1024/256 (22 frames, 4 FFTs side by side).
struct GlPolishArgs {
    const float* mag;     // (B, Tp, F)
    float* phase;         // (B, Tp, F), rows ctx .. Tx - 1 outside [keep_lo, keep_hi) updated in place
    const float* win;     // (n_fft,) analysis window
    const float* wsyn;    // (n_fft,) synthesis window / overlap / n_fft
    const float* fft_tw;  // (2, n_fft) twiddle table
    int Tp, Tx, ctx, keep_lo, keep_hi, F, hop, overlap, iters, teams;
};

// The polish's block: y (Tp hop), frames_rfft's area (that of the route n_fft
// takes), wsyn (n_fft), and where resident the grid's magnitudes and phases
// (Tp F each).
__host__ __device__ inline size_t polish_smem_floats(int Tp, int hop, int n_fft, int teams, bool resident) {
    const int F = n_fft / 2 + 1;
    return (size_t)Tp * hop + fft_area_floats(n_fft, teams) + (size_t)n_fft +
           (resident ? 2 * (size_t)Tp * F : 0);
}

template <bool kResident, bool kSmooth, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, 1) gl_polish_fft_kernel(GlPolishArgs a) {
    extern __shared__ __align__(16) float smem[];
    const long long b = blockIdx.x;
    const int hop = a.hop, ov = a.overlap, m = a.overlap - 1, F = a.F, Tp = a.Tp;
    const int n = ov * hop;
    const int n_out = Tp * hop;
    float* y = smem;  // 16-byte aligned: hop % 4 == 0
    const FftSmem fs = carve_fft<kSmooth, kSeven>(y + (size_t)n_out, n);
    float* wsyn = fs.buf + (size_t)a.teams * fft_buf_floats_of<kSmooth>(n);
    float* mag_s = wsyn + n;
    float* ph_s = mag_s + (size_t)Tp * F;
    const float* mag_g = a.mag + (size_t)b * Tp * F;
    float* ph_g = a.phase + (size_t)b * Tp * F;
    fft_stage<kSmooth, kSeven>(a.win, a.fft_tw, fs, n);
    for (int i = threadIdx.x; i < n; i += kThreads) wsyn[i] = __ldg(a.wsyn + i);
    if constexpr (kResident) {
        for (int i = threadIdx.x; i < Tp * F; i += kThreads) {
            mag_s[i] = __ldg(mag_g + i);
            ph_s[i] = ph_g[i];
        }
    }
    auto mag_at = [&](int i) -> float {
        if constexpr (kResident) return mag_s[i];
        else return __ldg(mag_g + i);
    };
    auto phase_at = [&](int i) -> float {
        if constexpr (kResident) return ph_s[i];
        else return __ldcg(ph_g + i);
    };
    float* ph_out = kResident ? ph_s : ph_g;
    const int ctx = a.ctx, lo = a.keep_lo, hi = a.keep_hi;
    for (int it = 0; it < a.iters; ++it) {
        for (int i = threadIdx.x; i < n_out; i += kThreads) y[i] = 0.0f;
        // frames_irfft starts with a barrier: y is zero and the last
        // analysis's phases are visible; it ends with one
        frames_irfft<kSmooth, kSeven>(
            Tp + m, ov, n, fs, wsyn, a.teams,
            [&](int r, int k, float& re, float& im) {
                const int f = r - m;
                if (f < 0) {
                    re = 0.0f;
                    im = 0.0f;
                } else {
                    const int i = f * F + k;
                    const float mg = mag_at(i);
                    float sn, cs;
                    sincosf(phase_at(i), &sn, &cs);
                    re = __fmul_rn(mg, cs);
                    im = __fmul_rn(mg, sn);
                }
            },
            [&](int r, int i, float v) {
                const int pos = (r - m) * hop + i;
                if (r >= m && pos < n_out) y[pos] = __fadd_rn(y[pos], v);
            });
        // frames_rfft starts with a barrier and ends with one
        frames_rfft<kSmooth, kSeven>(y + (size_t)ctx * hop, a.Tx - ctx, hop, n, fs, a.teams,
                    [&](int r, int k, float re, float im) {
                        const int f = ctx + r;
                        if (f < lo || f >= hi) ph_out[f * F + k] = atan2f(im, re);
                    });
    }
    if constexpr (kResident) {
        // frames_rfft's last barrier: every polished phase is in ph_s
        for (int i = ctx * F + threadIdx.x; i < a.Tx * F; i += kThreads) {
            const int f = i / F;
            if (f < lo || f >= hi) ph_g[i] = ph_s[i];
        }
    }
}

template <typename K>
static cudaError_t session_allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool session_args_ok(long long B, int T, int F, int hop, int overlap) {
    return B >= 1 && T >= 1 && F >= 2 && hop % 4 == 0 && overlap >= 1 && overlap <= 8;
}

}  // namespace att

extern "C" {

long long att_session_encode_smem_bytes(int rows, int hop, int Kn) {
    return (long long)(att::encode_smem_floats(rows, hop, Kn) * sizeof(float));
}

long long att_session_encode_fft_smem_bytes(int rows, int hop, int n_fft, int teams) {
    return (long long)(att::encode_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float));
}

long long att_session_roundtrip_smem_bytes(int rows, int overlap, int hop, int Kn, int Kp) {
    return (long long)(att::roundtrip_smem_floats(rows, overlap, hop, Kn, Kp) * sizeof(float));
}

long long att_session_roundtrip_fft_smem_bytes(int rows, int overlap, int hop, int teams) {
    return (long long)(att::roundtrip_fft_smem_floats(rows, overlap, hop, teams) * sizeof(float));
}

long long att_session_decode_smem_bytes(int rows, int overlap, int Kp) {
    return (long long)(att::decode_smem_floats(rows, overlap, Kp) * sizeof(float));
}

long long att_session_decode_fft_smem_bytes(int rows, int hop, int n_fft, int teams) {
    return (long long)(att::decode_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float));
}

long long att_gl_polish_smem_bytes(int Tp, int hop, int n_fft, int teams, int resident) {
    return (long long)(att::polish_smem_floats(Tp, hop, n_fft, teams, resident != 0) * sizeof(float));
}

// Kernel R (magnitude = 0) and the magnitude encode.  x (B, L) float32; out
// (B, T, F, 2), or (B, T, F) for the magnitude, every element written; hop a
// multiple of 4.  teams > 0 selects the FFT route: n_fft = overlap hop must be
// a power of two from 64 to 4096 (1 <= teams <= 4096 / n_fft), or the smooth
// route where fft_covers_smooth7(n_fft) (1 <= teams <= fft_smooth_max_teams;
// the radix-7 instance where n_fft has a factor 7), window (n_fft,) and fft_tw
// (2, n_fft) = (cos, -sin)(2 pi j / n_fft), rows even; wc / ws and Kn are not
// read.  teams == 0 selects the product route: wc / ws (Kn, F),
// Kn a multiple of 32 >= n_fft, zero rows past n_fft, rows <= 40 frames per
// block; window and fft_tw are not read.  Returns a cudaError_t.
int att_session_encode(const float* x, const float* wc, const float* ws, const float* window,
                       const float* fft_tw, float* out, long long B, long long L, int T, int F,
                       int hop, int overlap, int Kn, int rows, int teams, int magnitude,
                       void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool fft = teams > 0;
    const bool smooth = fft && !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (!session_args_ok(B, T, F, hop, overlap) || rows < 1 || F != n_fft / 2 + 1 ||
        (fft && ((smooth && !fft_covers_smooth7(n_fft)) || teams > max_teams || rows % 2 != 0)) ||
        (!fft && (Kn % kKC != 0 || rows > kMaxRows))) {
        return (int)cudaErrorInvalidValue;
    }
    SessionArgs a = {};
    a.x = x; a.wc = wc; a.ws = ws; a.win = window; a.fft_tw = fft_tw; a.out = out;
    a.L = L; a.T = T; a.F = F; a.hop = hop; a.overlap = overlap; a.Kn = Kn; a.rows = rows;
    a.teams = teams;
    a.n_tiles = (T + rows - 1) / rows;
    const size_t smem = fft ? (size_t)att_session_encode_fft_smem_bytes(rows, hop, n_fft, teams)
                            : (size_t)att_session_encode_smem_bytes(rows, hop, Kn);
    const dim3 grid((unsigned)(B * a.n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_ENC(MAG, FFT, SMOOTH, SEVEN)                                         \
    do {                                                                                \
        err = session_allow_smem(session_encode_kernel<MAG, FFT, SMOOTH, SEVEN>, smem);  \
        if (err != cudaSuccess) return (int)err;                                        \
        session_encode_kernel<MAG, FFT, SMOOTH, SEVEN><<<grid, kThreads, smem, s>>>(a);  \
    } while (0)
    if (magnitude) {
        if (seven) ATT_LAUNCH_ENC(true, true, true, true);
        else if (smooth) ATT_LAUNCH_ENC(true, true, true, false);
        else if (fft) ATT_LAUNCH_ENC(true, true, false, false);
        else ATT_LAUNCH_ENC(true, false, false, false);
    } else {
        if (seven) ATT_LAUNCH_ENC(false, true, true, true);
        else if (smooth) ATT_LAUNCH_ENC(false, true, true, false);
        else if (fft) ATT_LAUNCH_ENC(false, true, false, false);
        else ATT_LAUNCH_ENC(false, false, false, false);
    }
#undef ATT_LAUNCH_ENC
    return (int)cudaGetLastError();
}

// Kernels L (angles == nullptr) and M.  x (B, L); angles (B, Ta, F) with
// Ta >= T; out (B, T * hop), every sample written.  teams > 0 selects the FFT
// route: n_fft = overlap hop a power of two from 64 to 4096 (1 <= teams <=
// 4096 / n_fft), or the smooth route where fft_covers_smooth7(n_fft) (1 <=
// teams <= fft_smooth_max_teams; the radix-7 instance where n_fft has a
// factor 7), window (n_fft,) the analysis window, wsyn
// (n_fft,) the synthesis window / gain / n_fft (frames_fft.irfft_window),
// fft_tw (2, n_fft) = (cos, -sin)(2 pi j / n_fft), rows a multiple of 2
// overlap; wc, ws, syn, Kn and Kp are not read.  teams ==
// 0 selects the product route: wc / ws as for R; syn (overlap, Kp, hop), Kp a
// multiple of 32 >= 2F; rows output chunks per block, rows + overlap - 1 <=
// 40; window, wsyn and fft_tw are not read.  Returns a cudaError_t.
int att_session_roundtrip(const float* x, const float* angles, const float* wc, const float* ws,
                          const float* syn, const float* window, const float* wsyn,
                          const float* fft_tw, float* out, long long B, long long L, int T, int Ta,
                          int F, int hop, int overlap, int Kn, int Kp, int rows, int teams,
                          void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool fft = teams > 0;
    const bool smooth = fft && !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (!session_args_ok(B, T, F, hop, overlap) || rows < 1 || (angles != nullptr && Ta < T) ||
        (fft && ((smooth && !fft_covers_smooth7(n_fft)) || F != n_fft / 2 + 1 || teams > max_teams ||
                 rows % (2 * overlap) != 0)) ||
        (!fft && (Kn % kKC != 0 || Kp % kSynKC != 0 || Kp < 2 * F || rows + overlap - 1 > kMaxRows))) {
        return (int)cudaErrorInvalidValue;
    }
    SessionArgs a = {};
    a.x = x; a.angles = angles; a.wc = wc; a.ws = ws; a.syn = syn; a.out = out;
    a.win = window; a.wsyn = wsyn; a.fft_tw = fft_tw;
    a.L = L; a.T = T; a.Ta = Ta; a.F = F; a.hop = hop; a.overlap = overlap; a.Kn = Kn; a.Kp = Kp;
    a.rows = rows;
    a.teams = teams;
    a.n_tiles = (T + rows - 1) / rows;
    const size_t smem = fft ? roundtrip_fft_smem_floats(rows, overlap, hop, teams) * sizeof(float)
                            : roundtrip_smem_floats(rows, overlap, hop, Kn, Kp) * sizeof(float);
    dim3 grid((unsigned)(B * a.n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (fft) {
#define ATT_LAUNCH_RTF(RAND, SMOOTH, SEVEN)                                                 \
    do {                                                                                    \
        err = session_allow_smem(session_roundtrip_fft_kernel<RAND, SMOOTH, SEVEN>, smem);  \
        if (err != cudaSuccess) return (int)err;                                            \
        session_roundtrip_fft_kernel<RAND, SMOOTH, SEVEN><<<grid, kThreads, smem, s>>>(a);  \
    } while (0)
        if (seven) {
            if (angles != nullptr) ATT_LAUNCH_RTF(true, true, true); else ATT_LAUNCH_RTF(false, true, true);
        } else if (smooth) {
            if (angles != nullptr) ATT_LAUNCH_RTF(true, true, false); else ATT_LAUNCH_RTF(false, true, false);
        } else {
            if (angles != nullptr) ATT_LAUNCH_RTF(true, false, false); else ATT_LAUNCH_RTF(false, false, false);
        }
#undef ATT_LAUNCH_RTF
        return (int)cudaGetLastError();
    }
#define ATT_LAUNCH_RT(RPT, RAND)                                                   \
    do {                                                                           \
        err = session_allow_smem(session_roundtrip_kernel<RPT, RAND>, smem);       \
        if (err != cudaSuccess) return (int)err;                                   \
        session_roundtrip_kernel<RPT, RAND><<<grid, kThreads, smem, s>>>(a);       \
    } while (0)
#define ATT_LAUNCH_RT2(RPT)                                                        \
    do {                                                                           \
        if (angles != nullptr) ATT_LAUNCH_RT(RPT, true); else ATT_LAUNCH_RT(RPT, false); \
    } while (0)
    const int rpt = (rows + 7) / 8;
    if (rpt >= 5) ATT_LAUNCH_RT2(5);
    else if (rpt == 4) ATT_LAUNCH_RT2(4);
    else if (rpt == 3) ATT_LAUNCH_RT2(3);
    else if (rpt == 2) ATT_LAUNCH_RT2(2);
    else ATT_LAUNCH_RT2(1);
#undef ATT_LAUNCH_RT2
#undef ATT_LAUNCH_RT
    return (int)cudaGetLastError();
}

// Kernels P and S (angles == nullptr), and O's projection synthesis.  mag
// (B, T, F), or for S the complex spectrum as (B, T, F, 2) floats; angles (B,
// Ta, F) with Ta >= T; out (B, T * hop), every sample written.  teams > 0
// selects the FFT route: n_fft = overlap hop a power of two from 64 to 4096
// (1 <= teams <= 4096 / n_fft), or the smooth route where
// fft_covers_smooth7(n_fft) (1 <= teams <= fft_smooth_max_teams; the radix-7
// instance where n_fft has a factor 7), F = n_fft / 2 + 1, wsyn (n_fft,) the
// synthesis window / gain / n_fft
// (frames_fft.irfft_window), fft_tw (2, n_fft) = (cos, -sin)(2 pi j / n_fft),
// rows a multiple of 2 overlap; syn and Kp are not read.  teams == 0 selects
// the product route: syn as for L, rows <= 40 output chunks per block; wsyn
// and fft_tw are not read.  Returns a cudaError_t.
int att_session_decode(const float* mag, const float* angles, const float* syn, const float* wsyn,
                       const float* fft_tw, float* out, long long B, int T, int Ta, int F, int hop,
                       int overlap, int Kp, int rows, int teams, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool fft = teams > 0;
    const bool smooth = fft && !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (!session_args_ok(B, T, F, hop, overlap) || rows < 1 || (angles != nullptr && Ta < T) ||
        (fft && ((smooth && !fft_covers_smooth7(n_fft)) || F != n_fft / 2 + 1 || teams > max_teams ||
                 rows % (2 * overlap) != 0)) ||
        (!fft && (Kp % kSynKC != 0 || Kp < 2 * F || rows > 8 * 5))) {
        return (int)cudaErrorInvalidValue;
    }
    SessionArgs a = {};
    a.mag = mag; a.angles = angles; a.syn = syn; a.wsyn = wsyn; a.fft_tw = fft_tw; a.out = out;
    a.T = T; a.Ta = Ta; a.F = F; a.hop = hop; a.overlap = overlap; a.Kp = Kp; a.rows = rows;
    a.teams = teams;
    a.n_tiles = (T + rows - 1) / rows;
    const size_t smem = fft ? decode_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float)
                            : decode_smem_floats(rows, overlap, Kp) * sizeof(float);
    dim3 grid((unsigned)(B * a.n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (fft) {
#define ATT_LAUNCH_DECF(CPLX, SMOOTH, SEVEN)                                              \
    do {                                                                                  \
        err = session_allow_smem(session_decode_fft_kernel<CPLX, SMOOTH, SEVEN>, smem);   \
        if (err != cudaSuccess) return (int)err;                                          \
        session_decode_fft_kernel<CPLX, SMOOTH, SEVEN><<<grid, kThreads, smem, s>>>(a);   \
    } while (0)
        if (seven) {
            if (angles == nullptr) ATT_LAUNCH_DECF(true, true, true); else ATT_LAUNCH_DECF(false, true, true);
        } else if (smooth) {
            if (angles == nullptr) ATT_LAUNCH_DECF(true, true, false); else ATT_LAUNCH_DECF(false, true, false);
        } else {
            if (angles == nullptr) ATT_LAUNCH_DECF(true, false, false); else ATT_LAUNCH_DECF(false, false, false);
        }
#undef ATT_LAUNCH_DECF
        return (int)cudaGetLastError();
    }
#define ATT_LAUNCH_DEC(RPT, CPLX)                                                  \
    do {                                                                           \
        err = session_allow_smem(session_decode_kernel<RPT, CPLX>, smem);          \
        if (err != cudaSuccess) return (int)err;                                   \
        session_decode_kernel<RPT, CPLX><<<grid, kThreads, smem, s>>>(a);          \
    } while (0)
#define ATT_LAUNCH_DEC2(RPT)                                                       \
    do {                                                                           \
        if (angles == nullptr) ATT_LAUNCH_DEC(RPT, true); else ATT_LAUNCH_DEC(RPT, false); \
    } while (0)
    const int rpt = (rows + 7) / 8;
    if (rpt >= 5) ATT_LAUNCH_DEC2(5);
    else if (rpt == 4) ATT_LAUNCH_DEC2(4);
    else if (rpt == 3) ATT_LAUNCH_DEC2(3);
    else if (rpt == 2) ATT_LAUNCH_DEC2(2);
    else ATT_LAUNCH_DEC2(1);
#undef ATT_LAUNCH_DEC2
#undef ATT_LAUNCH_DEC
    return (int)cudaGetLastError();
}

// O's projection analysis on the product route (see
// gl_project_analysis_kernel).  y (B, Ly) float32; wc / ws as for R; phase (B,
// Tp, F), rows f0 .. Tx - 1 outside [keep_lo, keep_hi) written.  Tx - f0 <= 40
// frames; hop a multiple of 4.  Returns a cudaError_t.
int att_gl_project_analysis(const float* y, const float* wc, const float* ws, float* phase,
                            long long B, long long Ly, int Tp, int Tx, int f0, int keep_lo,
                            int keep_hi, int F, int hop, int Kn, void* stream) {
    using namespace att;
    if (B < 1 || F < 2 || hop % 4 != 0 || Kn % kKC != 0 || f0 < 0 || Tx - f0 < 1 ||
        Tx - f0 > kMaxRows || Tx > Tp) {
        return (int)cudaErrorInvalidValue;
    }
    GlProjectArgs a = {};
    a.y = y; a.wc = wc; a.ws = ws; a.phase = phase;
    a.Ly = Ly; a.Tp = Tp; a.Tx = Tx; a.f0 = f0; a.keep_lo = keep_lo; a.keep_hi = keep_hi;
    a.F = F; a.hop = hop; a.Kn = Kn;
    a.n_ct = (F + kColTile - 1) / kColTile;
    const size_t smem = encode_smem_floats(Tx - f0, hop, Kn) * sizeof(float);
    cudaError_t err = session_allow_smem(gl_project_analysis_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    gl_project_analysis_kernel<<<(unsigned)(B * a.n_ct), kThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// O's projection analysis on the FFT and smooth routes (see
// gl_project_analysis_fft_kernel).  y (B, Ly) float32; phase (B, Tp, F), rows
// f0 .. Tx - 1 outside [keep_lo, keep_hi) written; n_fft = overlap hop a power
// of two from 64 to 4096 (1 <= teams <= 4096 / n_fft), or fft_covers_smooth7(
// n_fft) (1 <= teams <= fft_smooth_max_teams; the radix-7 instance where n_fft
// has a factor 7), F = n_fft / 2 + 1, window (n_fft,) the analysis window,
// fft_tw (2, n_fft) = (cos, -sin)(2 pi j / n_fft); rows (even) frames a block;
// hop a multiple of 4.  Returns a cudaError_t.
int att_gl_project_analysis_fft(const float* y, const float* window, const float* fft_tw, float* phase,
                                long long B, long long Ly, int Tp, int Tx, int f0, int keep_lo, int keep_hi,
                                int F, int hop, int overlap, int rows, int teams, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool smooth = !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    if (B < 1 || hop % 4 != 0 || overlap < 1 || overlap > 8 || F != n_fft / 2 + 1 ||
        (smooth && !fft_covers_smooth7(n_fft)) || teams < 1 ||
        teams > (smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft)) || rows < 2 || rows % 2 != 0 ||
        f0 < 0 || Tx - f0 < 1 || Tx > Tp) {
        return (int)cudaErrorInvalidValue;
    }
    GlProjectArgs a = {};
    a.y = y; a.win = window; a.fft_tw = fft_tw; a.phase = phase;
    a.Ly = Ly; a.Tp = Tp; a.Tx = Tx; a.f0 = f0; a.keep_lo = keep_lo; a.keep_hi = keep_hi;
    a.F = F; a.hop = hop; a.n_fft = n_fft; a.rows = rows; a.teams = teams;
    a.n_ct = (Tx - f0 + rows - 1) / rows;
    const size_t smem = encode_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float);
    const dim3 grid((unsigned)(B * a.n_ct));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_ANA(SMOOTH, SEVEN)                                                         \
    do {                                                                                      \
        err = session_allow_smem(gl_project_analysis_fft_kernel<SMOOTH, SEVEN>, smem);        \
        if (err != cudaSuccess) return (int)err;                                              \
        gl_project_analysis_fft_kernel<SMOOTH, SEVEN><<<grid, kThreads, smem, s>>>(a);        \
    } while (0)
    if (seven) ATT_LAUNCH_ANA(true, true);
    else if (smooth) ATT_LAUNCH_ANA(true, false);
    else ATT_LAUNCH_ANA(false, false);
#undef ATT_LAUNCH_ANA
    return (int)cudaGetLastError();
}

// O's polish (see gl_polish_fft_kernel).  mag, phase (B, Tp, F) float32, Tp =
// Tx + overlap - 1; phase rows ctx .. Tx - 1 outside [keep_lo, keep_hi)
// updated in place after `iters` projections, every other row untouched.
// n_fft = overlap hop a power of two from 64 to 4096 (1 <= teams <= 4096 /
// n_fft), or on the smooth route where fft_covers_smooth7(n_fft) (1 <= teams
// <= fft_smooth_max_teams(n_fft); the radix-7 instance where n_fft has a
// factor 7), F = n_fft / 2 + 1, hop a multiple of 4;
// window (n_fft,) the analysis window, wsyn (n_fft,) the synthesis window /
// overlap / n_fft (frames_fft.irfft_window), fft_tw (2, n_fft) = (cos,
// -sin)(2 pi j / n_fft); resident != 0 holds the grid in shared memory.
// Returns a cudaError_t.
int att_gl_polish(const float* mag, float* phase, const float* window, const float* wsyn,
                  const float* fft_tw, long long B, int Tp, int Tx, int ctx, int keep_lo, int keep_hi,
                  int F, int hop, int overlap, int iters, int teams, int resident, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool smooth = !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (!session_args_ok(B, Tp, F, hop, overlap) || (smooth && !fft_covers_smooth7(n_fft)) ||
        F != n_fft / 2 + 1 || teams < 1 || teams > max_teams || ctx < 0 || ctx >= Tx ||
        Tx + overlap - 1 != Tp || iters < 1) {
        return (int)cudaErrorInvalidValue;
    }
    GlPolishArgs a = {};
    a.mag = mag; a.phase = phase; a.win = window; a.wsyn = wsyn; a.fft_tw = fft_tw;
    a.Tp = Tp; a.Tx = Tx; a.ctx = ctx; a.keep_lo = keep_lo; a.keep_hi = keep_hi; a.F = F; a.hop = hop;
    a.overlap = overlap; a.iters = iters; a.teams = teams;
    const size_t smem = polish_smem_floats(Tp, hop, n_fft, teams, resident != 0) * sizeof(float);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_POL(RES, SMOOTH, SEVEN)                                                \
    do {                                                                                  \
        err = session_allow_smem(gl_polish_fft_kernel<RES, SMOOTH, SEVEN>, smem);         \
        if (err != cudaSuccess) return (int)err;                                          \
        gl_polish_fft_kernel<RES, SMOOTH, SEVEN><<<(unsigned)B, kThreads, smem, s>>>(a);  \
    } while (0)
    if (seven) {
        if (resident) ATT_LAUNCH_POL(true, true, true); else ATT_LAUNCH_POL(false, true, true);
    } else if (smooth) {
        if (resident) ATT_LAUNCH_POL(true, true, false); else ATT_LAUNCH_POL(false, true, false);
    } else {
        if (resident) ATT_LAUNCH_POL(true, false, false); else ATT_LAUNCH_POL(false, false, false);
    }
#undef ATT_LAUNCH_POL
    return (int)cudaGetLastError();
}

}  // extern "C"
