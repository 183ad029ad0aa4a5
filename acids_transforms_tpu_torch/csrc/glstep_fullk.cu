// Full-K momentum Griffin-Lim step for any window, one kernel, for Hopper (sm_90a).
//
// Replaces, from the JAX package's ops/pallas/glstep.py:
//   gl_fullk_kernel, gl_fullk_fft_kernel<false / true[, true]>
//                    <- _gl_kernel_fullk_momentum  (via _gl_fullk_call /
//                       make_gl_momentum_step_fullk)
//
// One iteration for a window without cosine-sum taps (the DGT's gaussian):
//   frames[t] = [mag * are | mag * aim][t] @ (windowed inverse real DFT)
//   u         = overlap-add(frames) / envelope          (the un-trimmed signal)
//   p         = u with its first and last n_fft / 2 samples replaced by the
//               reflection of the trimmed signal u[n_fft/2, n_fft/2 + L)
//   R[t]      = p[t hop, t hop + n_fft) @ (windowed DFT, cos | -sin)
//   u = R - mom * tprev;  angles = u / max(|u|, 1e-16)
// with L = (T - 1) hop.  That is the eager loop's ISTFT (centre trim) and
// STFT (reflect padding) per iteration: the same boundary rule as the loop
// it replaces in the chain's griffin_lim / pghi_gl.  The TPU kernel
// re-frames the un-trimmed signal instead (its overlap-add tails): seeded by
// PGHI that rule leaves the first and last frames far off the target
// (ROADMAP Queue 3), so this port does not copy it.  Frames outside [0, T)
// are zero; the envelope is the overlap-add of the squared window over the
// true T frames, one where it falls below eps^2.
//
// What bounds it on this card: the function is bound by bytes (9 float
// arrays of F values per frame) against an inverse and a forward FFT per
// frame.  Three routes, chosen by (n_fft, hop) alone (the wrapper's
// glstep._fullk_plan):
// * the FFT route (gl_fullk_fft_kernel<false>, a power of two from 64 to
//   4096): fft_smem.cuh's frames_irfft for the synthesis and frames_rfft for
//   the analysis, an FFT's operations a frame; the samples of the block and
//   the FFT area take 109 KB at 1024/256 (56 frames a block), so two blocks
//   share an SM.  What holds it back: shared-memory passes and barriers, and
//   the halo frames' synthesis done again by the neighbouring block (64
//   frames synthesized for 56);
// * the smooth route (gl_fullk_fft_kernel<true>, n_fft even, 2^a 3^b 5^c,
//   64 to 4096, no power of two: 768, 1200, 1920, ...; where its block
//   fits): the same kernel on the mixed-radix frames_irfft<true> /
//   frames_rfft<true> (radix 5, 3, 4, 2 stages, out of place), twiddles j <
//   fft_smooth_table(n), wsyn = window / n_fft rounded once from float64;
//   where n_fft has a factor 7 as well (fft_covers_smooth7: 896, 1344, 1568,
//   ...) its radix-7 instance, gl_fullk_fft_kernel<true, true>
//   (frames_irfft<true, true> / frames_rfft<true, true>: a radix-7 stage
//   first);
// * the product route (gl_fullk_kernel, every other n_fft: 1408, 8192, ...)
//   keeps the TPU kernel's two full-length products, 2 * n_fft * F
//   multiply-adds per frame for the synthesis and as many for the analysis
//   (2.1 M at n_fft 1024), about 230 flop per byte, so its own ceiling is the
//   card's fp32 FMA rate.  Its design follows.
//
// Design: a block owns one batch row and tile_t output frames t0 ..  Their
// padded samples are the hop chunks t0 - 1 .. t0 - 2 + R (R <= 8 kRPT; the
// chunk before the tile holds the one sample the last frame's reflection
// reads, and R >= overlap + 2 holds chunk `overlap`, the source of the first
// frame's first sample), which need the frames from t0 - overlap on: those [re | im] rows
// are built in shared memory (mag * angles, zero outside [0, T)) and the
// synthesis is the overlap-add-folded product of synth_ola.cuh, written
// straight into a shared-memory sample buffer.  The envelope division and
// the two reflections (every sample a frame of the tile reads has its source
// in the buffer) run in place there.  The analysis is then the full-K front
// end of the forward kernels (dft_common.cuh:analysis_tile with the
// contraction running to n_fft at row stride hop), whose work area takes the
// place of the synthesis operands.  Blocks recompute their halo, so they are
// independent; the time signal never leaves shared memory.  R and tile_t =
// min(32, R - overlap) are chosen by the wrapper so that both phases fit
// shared memory (R = 32 and 29 frames at n_fft 768, hop 256).  An R that is
// no multiple of 8 leaves the synthesis's last rows idle (synth_ola.cuh).
// Where not even overlap + 2 chunks' whole [re | im] rows fit (n_fft 8192),
// the rows are built and multiplied in slabs of Ks contraction columns, each
// slab's product added to the sample buffer: R = 15 in slabs of 1056 at
// 8192 / 2048.
//
// Arithmetic is fp32 FMA with fp32 accumulation: no tensor cores.  What
// keeps the product route from that ceiling: one block of 8 warps per SM
// (the [re | im] rows of 35 frames take 148 KB at 768/256), so latency is
// hidden by instruction-level parallelism only, and the halo frames'
// synthesis is done again by the neighbouring block.
#include <math.h>

#include "dft_common.cuh"
#include "fft_smem.cuh"
#include "synth_ola.cuh"

namespace att {

struct GlFullkArgs {
    const float* mag;   // (B, T, F)
    const float* are;   // angles in
    const float* aim;
    const float* tre;   // previous projection in
    const float* tim;
    const float* env;   // (T + overlap - 1, hop), > 0
    const float* syn;   // (overlap, Kp, hop) windowed inverse DFT rows [A; B; 0]
    const float* wc;    // (n_fft, F) windowed analysis basis, cos
    const float* ws;    //                                   -sin
    const float* win;   // FFT route: (n_fft,) window
    const float* wsyn;  //            (n_fft,) window / n_fft
    const float* fft_tw;  //          (2, n_fft) twiddle table
    float* nare;        // outputs (B, T, F)
    float* naim;
    float* rre;
    float* rim;
    int T, F, hop, overlap, Kp, rows, tile_t, n_tiles;
    int Ks;             // synthesis slab: contraction columns of [re | im] held at a time
    int teams;          // FFT route: FFTs side by side (0: the product route)
    float mom;
};

// Ks = Kp holds the frames' whole [re | im] rows; a narrower slab bounds
// shared memory for the shapes where they do not fit.
__host__ __device__ inline size_t gl_fullk_smem_floats(int rows, int overlap, int hop, int Ks) {
    size_t syn = (size_t)(rows + overlap - 1) * Ks + (size_t)kSynKC * kSynCols;
    size_t ana = (size_t)ana_work_floats();
    return (size_t)rows * hop + (syn > ana ? syn : ana);
}

// The envelope division and the two reflections of the samples of chunks c0 ..
// c0 + R - 1, in place (both routes).  Starts with a barrier.
__device__ void gl_fullk_boundary(float* samples, const GlFullkArgs& a, int R, int c0) {
    const int tid = threadIdx.x;
    const int T = a.T, hop = a.hop, ov = a.overlap, m = a.overlap - 1;
    __syncthreads();
    for (int i = tid; i < R * hop; i += kThreads) {
        const int c = c0 + i / hop;  // chunk of the un-trimmed signal
        if (c >= 0 && c < T + m) samples[i] = __fdiv_rn(samples[i], __ldg(a.env + (size_t)c * hop + (i - (i / hop) * hop)));
    }
    __syncthreads();
    // reflect padding of the trimmed signal u[half, half + L): padded sample
    // j takes u[half + x], x the reflection of j - half with period 2 (L - 1)
    // (the head u[n_fft - j] and the tail u[2 (L + half - 1) - j] when one
    // reflection covers the pad; a clip of L <= half samples reflects again,
    // as the eager loop's padding does); the sources lie inside the trimmed
    // signal, so the pass can run in place
    {
        const long long half = (long long)ov * hop / 2;
        const long long L = (long long)(T - 1) * hop;
        const long long period = 2 * (L - 1);
        const long long base = (long long)c0 * hop;
        for (int i = tid; i < R * hop; i += kThreads) {
            const long long j = base + i;
            if (j < 0 || (j >= half && j < L + half)) continue;
            long long x = (j - half) % period;
            if (x < 0) x += period;
            if (x >= L) x = period - x;
            const long long src = half + x - base;
            if (src >= 0 && src < (long long)R * hop) samples[i] = samples[src];
        }
    }
}

template <int kRPT>
__global__ void __launch_bounds__(kThreads) gl_fullk_kernel(GlFullkArgs a) {
    static_assert(kSynThreads == kThreads, "one block shape for both phases");
    extern __shared__ __align__(16) float smem[];
    const int R = a.rows;  // hop chunks of samples a block computes, <= 8 kRPT
    const int tid = threadIdx.x;
    const int T = a.T, F = a.F, hop = a.hop, ov = a.overlap, Kp = a.Kp, m = a.overlap - 1;
    const int Ks = a.Ks;
    float* samples = smem;                      // [R][hop]
    float* S = samples + (size_t)R * hop;       // [R + m][Ks] a slab of the frames' [re | im]
    float* Bst = S + (size_t)(R + m) * Ks;      // [kSynKC][kSynCols]
    AnaWork w = carve_ana(S);                   // the analysis reuses that area

    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int t0 = (int)(blk - b * a.n_tiles) * a.tile_t;
    const int c0 = t0 - 1;  // chunk of sample buffer row 0
    const size_t bofs = (size_t)b * T * F;

    // ---- synthesis: frames c0 - m .. c0 + R - 1 -> samples of chunks c0 .. c0 + R - 1,
    // one slab of Ks contraction columns (column k2 < F: mag * are, < 2F: mag * aim) at a time
    for (int s0 = 0; s0 < Kp; s0 += Ks) {
        const int kw = min(Ks, Kp - s0);
        if (s0 > 0) __syncthreads();  // the previous slab's product has read S
        for (int q = 0; q < R + m; ++q) {
            const int f = c0 - m + q;
            float* row = S + (size_t)q * kw;
            if (f >= 0 && f < T) {
                const size_t o = bofs + (size_t)f * F;
                for (int c = tid; c < kw; c += kThreads) {
                    const int k2 = s0 + c;
                    float v = 0.0f;
                    if (k2 < F) {
                        v = __ldg(a.mag + o + k2) * __ldg(a.are + o + k2);
                    } else if (k2 < 2 * F) {
                        v = __ldg(a.mag + o + k2 - F) * __ldg(a.aim + o + k2 - F);
                    }
                    row[c] = v;
                }
            } else {
                for (int c = tid; c < kw; c += kThreads) row[c] = 0.0f;
            }
        }
        // synth_ola_tile starts with a barrier before it reads S
        synth_ola_tile<kRPT>(S, Bst, a.syn, Kp, hop, ov, 0, R, samples, s0, kw, s0 > 0);
    }
    gl_fullk_boundary(samples, a, R, c0);
    // analysis_tile starts with a barrier before it reads the samples

    // ---- analysis: frames t0 .. t0 + tile_t - 1 of the samples, momentum update
    const int n_ct = n_col_tiles(F, 0);
    for (int ct = 0; ct < n_ct; ++ct) {
        analysis_tile(samples + hop, a.tile_t, a.tile_t, hop, ov, F, ct, 0, a.wc, a.ws, nullptr,
                      nullptr, w, ov * hop);
        const int k0 = ct * kColTile;
        for (int idx = tid; idx < a.tile_t * kColTile; idx += kThreads) {
            const int t = idx / kColTile;
            const int c = idx - t * kColTile;
            const int k = k0 + c;
            const int f = t0 + t;
            if (k >= F || f >= T) continue;
            const size_t o = bofs + (size_t)f * F + k;
            const float r_re = w.Xre[idx];
            const float r_im = w.Xim[idx];
            const float ure = r_re - a.mom * __ldg(a.tre + o);
            const float uim = r_im - a.mom * __ldg(a.tim + o);
            const float nrm = fmaxf(sqrtf(ure * ure + uim * uim), 1e-16f);
            a.rre[o] = r_re;
            a.rim[o] = r_im;
            a.nare[o] = ure / nrm;
            a.naim[o] = uim / nrm;
        }
    }
}

// The FFT or the smooth route's shared memory: the samples of `rows` chunks,
// frames_rfft's area on the route n takes (window, twiddles, teams'
// buffers) and the synthesis window.
__host__ __device__ inline size_t gl_fullk_fft_smem_floats(int rows, int hop, int n, int teams) {
    return (size_t)rows * hop + fft_area_floats(n, teams) + (size_t)n;
}

// J on the FFT route (n_fft = overlap hop a power of two from 64 to 4096), or
// with kSmooth on the smooth route (fft_covers_smooth(n_fft): the
// mixed-radix stages, wsyn's 1 / n fold rounded once; with kSeven where
// fft_covers_smooth7(n_fft) and n_fft has a factor 7, the radix-7 stage
// too, carve_fft / fft_stage / frames_irfft / frames_rfft all told so, so
// the table is fft_smooth_table<true>(n) long): a block owns one
// batch row and the tile_t frames t0 .. (tile_t a multiple of
// 2 overlap), its samples the rows = tile_t + overlap chunks c0 = t0 - 1 ...
// Synthesis: frames_irfft of the frames t0 - overlap .. t0 + tile_t + overlap
// - 1 (pairs (f, f + overlap) for f mod 2 overlap >= overlap: the session-wide
// pairing, so a frame's rounding does not depend on its block; the last
// frame is only a partner), their spectra mag * (are, aim) read from device
// memory, frames outside [0, T) zero and not added, every other frame added
// into the samples in class order f mod overlap.  Then the envelope division
// and the reflections in place, and frames_rfft of the tile's frames (pairs
// (2j, 2j + 1): t0 is even) with the momentum update as its emit.  Every
// operation is rounded on its own (__fmul_rn, ...), so that the plain version
// (ops/cuda/glstep.py:gl_momentum_step_fullk_reference) repeats it.
template <bool kSmooth, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, 2) gl_fullk_fft_kernel(GlFullkArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int R = a.rows, T = a.T, F = a.F, hop = a.hop, ov = a.overlap;
    const int n = ov * hop;
    float* samples = smem;  // [R][hop]
    const FftSmem fs = carve_fft<kSmooth, kSeven>(samples + (size_t)R * hop, n);
    float* wsyn = fs.buf + (size_t)a.teams * fft_buf_floats_of<kSmooth>(n);
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int t0 = (int)(blk - b * a.n_tiles) * a.tile_t;
    const int c0 = t0 - 1;  // chunk of sample buffer row 0
    const size_t bofs = (size_t)b * T * F;
    fft_stage<kSmooth, kSeven>(a.win, a.fft_tw, fs, n);
    for (int i = threadIdx.x; i < n; i += kThreads) wsyn[i] = __ldg(a.wsyn + i);
    for (int i = threadIdx.x; i < R * hop; i += kThreads) samples[i] = 0.0f;
    // local frame r is frame t0 - overlap + r; frames_irfft starts with a barrier
    const int f0 = t0 - ov;
    frames_irfft<kSmooth, kSeven>(
        min(a.tile_t + 2 * ov, T - f0), ov, n, fs, wsyn, a.teams,
        [&](int r, int k, float& re, float& im) {
            const int f = f0 + r;
            if (f < 0 || f >= T) {
                re = 0.0f;
                im = 0.0f;
                return;
            }
            const size_t o = bofs + (size_t)f * F + k;
            const float mg = __ldg(a.mag + o);
            re = __fmul_rn(mg, __ldg(a.are + o));
            im = __fmul_rn(mg, __ldg(a.aim + o));
        },
        [&](int r, int i, float v) {
            const int f = f0 + r;
            const int pos = (f - c0) * hop + i;
            if (f >= 0 && f < T && pos >= 0 && pos < R * hop) samples[pos] = __fadd_rn(samples[pos], v);
        });
    gl_fullk_boundary(samples, a, R, c0);
    // frames_rfft starts with a barrier
    const float mom = a.mom;
    frames_rfft<kSmooth, kSeven>(samples + hop, min(a.tile_t, T - t0), hop, n, fs, a.teams,
                [&](int r, int k, float r_re, float r_im) {
                    const size_t o = bofs + (size_t)(t0 + r) * F + k;
                    const float ure = __fsub_rn(r_re, __fmul_rn(mom, __ldg(a.tre + o)));
                    const float uim = __fsub_rn(r_im, __fmul_rn(mom, __ldg(a.tim + o)));
                    const float nrm =
                        fmaxf(__fsqrt_rn(__fadd_rn(__fmul_rn(ure, ure), __fmul_rn(uim, uim))), 1e-16f);
                    a.rre[o] = r_re;
                    a.rim[o] = r_im;
                    a.nare[o] = __fdiv_rn(ure, nrm);
                    a.naim[o] = __fdiv_rn(uim, nrm);
                });
}

template <typename K>
static cudaError_t gl_fullk_allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace att

extern "C" {

// Shared memory of one block computing `rows` chunks (overlap + 2 <= rows <=
// 32) with synthesis slabs of Ks columns.
long long att_gl_fullk_smem_bytes(int rows, int overlap, int hop, int Ks) {
    return (long long)(att::gl_fullk_smem_floats(rows, overlap, hop, Ks) * sizeof(float));
}

// Shared memory of one block of the FFT or the smooth route (the one n_fft
// takes) computing `rows` chunks with `teams` FFTs side by side.
long long att_gl_fullk_fft_smem_bytes(int rows, int hop, int n_fft, int teams) {
    return (long long)(att::gl_fullk_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float));
}

// Kernel J.  Spectrogram arrays (B, T, F) float32 contiguous, outputs not
// aliasing inputs; env (T + overlap - 1, hop); hop a multiple of 32; T >= 2.
// teams > 0 selects the FFT route: n_fft = overlap hop a power of two from 64
// to 4096 (1 <= teams <= 4096 / n_fft), or the smooth route where
// fft_covers_smooth7(n_fft) (1 <= teams <= fft_smooth_max_teams(n_fft); the
// radix-7 instance where n_fft has a factor 7), window and wsyn (n_fft,) (the
// window, and the window / n_fft: on the smooth route rounded once from
// float64), fft_tw (2, n_fft) = (cos, -sin)(2 pi j /
// n_fft), tile_t a multiple of 2 overlap and rows = tile_t + overlap; syn, wc, ws,
// Kp and Ks are not read.  teams == 0 selects the product route: syn
// (overlap, Kp, hop) with Kp a multiple of 32, Kp >= 2F; wc / ws (overlap *
// hop, F); rows chunks per block (overlap + 2 <= rows <= 32), tile_t <=
// min(32, rows - overlap) frames; synthesis slabs of Ks columns, a multiple of
// 32 up to Kp; window, wsyn and fft_tw are not read.  A clip whose reflection
// sources lie outside one block's chunks (the wrapper checks) is not covered.
// Returns a cudaError_t.
int att_gl_fullk_step(const float* mag, const float* are, const float* aim, const float* tre,
                      const float* tim, const float* env, const float* syn, const float* wc,
                      const float* ws, const float* window, const float* wsyn,
                      const float* fft_tw, long long B, int T, int F, int hop, int overlap,
                      int Kp, int rows, int tile_t, int Ks, int teams, float mom, float* nare,
                      float* naim, float* rre, float* rim, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool fft = teams > 0;
    const bool smooth = fft && !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (B < 1 || T < 2 || overlap < 2 || hop % kKC != 0 || tile_t < 1 ||
        (fft && ((smooth && !fft_covers_smooth7(n_fft)) || F != n_fft / 2 + 1 || teams > max_teams ||
                 tile_t % (2 * overlap) != 0 || rows != tile_t + overlap)) ||
        (!fft && (Kp % kSynKC != 0 || Kp < 2 * F || tile_t > kRowGroup || tile_t + overlap > rows ||
                  Ks < kSynKC || Ks > Kp || Ks % kSynKC != 0 || rows < overlap + 2 || rows > 32))) {
        return (int)cudaErrorInvalidValue;
    }
    GlFullkArgs a = {};
    a.mag = mag; a.are = are; a.aim = aim; a.tre = tre; a.tim = tim; a.env = env;
    a.syn = syn; a.wc = wc; a.ws = ws; a.win = window; a.wsyn = wsyn; a.fft_tw = fft_tw;
    a.nare = nare; a.naim = naim; a.rre = rre; a.rim = rim;
    a.T = T; a.F = F; a.hop = hop; a.overlap = overlap; a.Kp = Kp; a.rows = rows; a.tile_t = tile_t;
    a.n_tiles = (T + tile_t - 1) / tile_t;
    a.Ks = Ks;
    a.teams = teams;
    a.mom = mom;
    const size_t smem = fft ? gl_fullk_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float)
                            : gl_fullk_smem_floats(rows, overlap, hop, Ks) * sizeof(float);
    dim3 grid((unsigned)(B * a.n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (fft) {
#define ATT_LAUNCH_GLFKF(SMOOTH, SEVEN)                                            \
    do {                                                                           \
        err = gl_fullk_allow_smem(gl_fullk_fft_kernel<SMOOTH, SEVEN>, smem);       \
        if (err != cudaSuccess) return (int)err;                                   \
        gl_fullk_fft_kernel<SMOOTH, SEVEN><<<grid, kThreads, smem, s>>>(a);        \
    } while (0)
        if (seven) ATT_LAUNCH_GLFKF(true, true);
        else if (smooth) ATT_LAUNCH_GLFKF(true, false);
        else ATT_LAUNCH_GLFKF(false, false);
#undef ATT_LAUNCH_GLFKF
        return (int)cudaGetLastError();
    }
#define ATT_LAUNCH_GLFK(RPT)                                                \
    do {                                                                    \
        err = gl_fullk_allow_smem(gl_fullk_kernel<RPT>, smem);              \
        if (err != cudaSuccess) return (int)err;                            \
        gl_fullk_kernel<RPT><<<grid, kThreads, smem, s>>>(a);               \
    } while (0)
    const int rpt = (rows + 7) / 8;
    if (rpt == 4) ATT_LAUNCH_GLFK(4);
    else if (rpt == 3) ATT_LAUNCH_GLFK(3);
    else if (rpt == 2) ATT_LAUNCH_GLFK(2);
    else ATT_LAUNCH_GLFK(1);
#undef ATT_LAUNCH_GLFK
    return (int)cudaGetLastError();
}

}  // extern "C"
