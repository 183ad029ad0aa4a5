// Momentum Griffin-Lim step(s) in one kernel for Hopper (sm_90a).
//
// Replaces, from the JAX package's ops/pallas/glstep.py:
//   gl_step_kernel, chain == 1  <- _gl_kernel_momentum        (via _gl_call, iters=1)
//   gl_step_kernel, chain >= 2  <- _gl_kernel_momentum_chain  (via _gl_call, iters=k)
//   gl_step_kernel, project     <- _gl_kernel                 (via gl_project): the
//                                  consistency projection alone, no momentum
//   gl_step_fft_kernel<false>   <- the same three where n_fft is a power of two
//                                  from 64 to 4096 (the FFT route, below)
//   gl_step_fft_kernel<true>    <- the same three where n_fft is even,
//                                  2^a 3^b 5^c, 64 to 4096, no power of two
//                                  (the smooth route, below)
//   gl_step_fft_kernel<true, true> <- the same three where n_fft is even,
//                                  2^a 3^b 5^c 7^d with a factor 7, 64 to
//                                  4096 (the smooth route's radix-7 instance)
//
// One iteration: Y = taps_conv(mag * angles); D[c] = sum_j conj(tw_j) Y[c - j];
// samples[c] = [Dre | Dim] @ [ICT; IST] / envelope[c]; C = samples @ [cos | -sin];
// X[t] = sum_j tw_j C[t + j]; R = taps_conv(X); u = R - mom * tprev;
// angles = u / max(|u|, 1e-16).  Boundary rule of the JAX kernel: spectrogram
// rows outside [0, T) are zero, the un-trimmed overlap-add signal is re-framed
// in place, the envelope is one outside the signal.  The imaginary part of
// the angles at the nyquist bin is ignored (as the TPU kernel's layout for
// n_fft % 256 == 0 does); at DC it enters the taps conv like any bin.
//
// What bounds it on this card: the function itself is bound by bytes (9
// float arrays of F values moved per frame, 18 KB, against the two FFTs an
// iteration needs, about 5 n_fft log2 n_fft operations).  This design is
// not: it keeps the chunk products of the kernel it replaces, 4 * hop * F
// fp32 multiply-adds per frame and iteration (0.53 M at hop 256, F 513),
// about 57 flop per byte, above the fp32 ridge of 20 flop/byte, so its own
// ceiling is the card's fp32 FMA rate.
//
// Design: a block owns one batch row and `tile_t` output frames, and
// recomputes its own halo (chain * (overlap - 1) frames per side), so blocks
// are independent.  The time signal of the block's window lives in shared
// memory between the synthesis and the analysis product and never reaches
// device memory.  The synthesis product accumulates in registers over bin
// tiles of 32 with its operands staged through shared memory one tile ahead
// of the multiply-adds; the analysis side is the front end shared with the
// forward kernel (dft_common.cuh).  Rows are walked in groups of 32; the
// wrapper picks the largest `tile_t` that fits shared memory and evens it
// out over the tiles, which keeps the halo's share of the work smallest.
// With chain >= 2 the same body runs `chain` times over a shrinking window;
// the intermediate angles and the previous projection do not fit shared
// memory at F = 513 (4 arrays of (tile_t + 2 halo) x F floats), so they go
// through a per-block private scratch in device memory that the wrapper
// allocates.  Only __syncthreads() orders its accesses: no block reads
// another block's scratch.
//
// Arithmetic is fp32 FMA with fp32 accumulation: no tensor cores yet.  What
// keeps it from that ceiling: one block of 8 warps per SM (the window's samples
// and the staged operands fill shared memory), so latency is hidden by
// instruction-level parallelism only; chaining recomputes the halo, which
// costs operations, the very thing this design is short of.
//
// Three routes, chosen by (n_fft, hop) alone (the wrapper's
// glstep.gl_step_route): the FFT route (gl_step_fft_kernel<false>) where
// n_fft is a power of two from 64 to 4096, the smooth route
// (gl_step_fft_kernel<true>) where fft_covers_smooth(n_fft) (768, 1200, 640,
// 1920, ...), or its radix-7 instance (gl_step_fft_kernel<true, true>) where
// fft_covers_smooth7(n_fft) and n_fft has a factor 7 (896, 1344, 1568, ...),
// and its block fits, the chunk products above (gl_step_kernel) for every
// other n_fft (1408, 8192, ...).  The FFT route:
// * the same function, with the window in the time domain: frames_irfft of
//   mag * angles under window / n_fft (fft_smem.cuh), then the overlap-add
//   in class order, the envelope division, the in-place re-framing of the
//   un-trimmed signal and frames_rfft under the window, the update.  The
//   product reads Im(bin 0) through the taps conv, which irfft does not: that
//   term is added unwindowed to every sample of a frame, Im(Y_0) times the
//   table -(2 / n) sum_{p >= 1} taps[p] sin(2 pi p i / n) (the oracle's
//   "leak"); nyquist's imaginary part stays dropped;
// * a block owns one batch row and tile_t frames t0 .. (tile_t a multiple of
//   2 overlap, so t0 starts a pair group of the whole clip), its samples the
//   chunks t0 .. t0 + tile_t + overlap - 2, and synthesizes the frames t0 -
//   overlap .. t0 + tile_t + overlap - 1 paired (f, f + overlap) for f mod 2
//   overlap >= overlap, as J does: no frame's rounding depends on its block;
// * a chain of `chain` iterations is one cooperative launch of at most as
//   many blocks as the card holds at once, each walking tiles in a strided
//   loop, a barrier across the grid between iterations; the state between
//   iterations goes through device memory (the outputs and one scratch set,
//   in turns, read through L2), so every iteration is one step over the
//   whole clip and the chain equals `chain` single steps bit for bit.  No
//   halo is recomputed: a halo that shrinks by overlap - 1 frames an
//   iteration would move the pair grid, and at 1024/256 a chain of 4 would
//   leave a two-blocks-an-SM tile of 8 frames for 48 frames of halo;
// * what bounds it: as J, bytes against an inverse and a forward FFT a frame;
//   what holds it back, shared-memory passes and barriers, and the halo
//   frames' synthesis done again by the neighbouring block.  Every operation
//   is rounded on its own (__fmul_rn, ...), so the plain version
//   (ops/cuda/glstep.py:_project_fft) repeats it.
// The smooth route is the same kernel on fft_smem.cuh's mixed-radix
// frames_irfft<true> / frames_rfft<true> (radix 5, 3, 4, 2 stages, out of
// place between two buffer halves, teams of a power of two of threads),
// its twiddles j < fft_smooth_table(n), and wsyn = window / n_fft rounded
// once from float64 (frames_fft.irfft_window(smooth=True)); the pairing, the
// leak, the envelope and the update are the FFT route's.  Its radix-7
// instance (kSeven) tells carve_fft, fft_stage, frames_irfft and frames_rfft
// so: a radix-7 stage first, the table fft_smooth_table<true>(n) long (the
// layout, fft_smooth_smem_floats, counts sevens for every n, so the offsets
// below are the same for both instances).  Plain version _project_fft(...,
// smooth=True).
#include <math.h>

#include "dft_common.cuh"
#include "fft_smem.cuh"

namespace att {

constexpr int kSynKT = 32;          // bins per synthesis tile
constexpr int kSynK = 2 * kSynKT;   // contraction length: [Dre | Dim]
constexpr int kSynN = 256;          // sample columns per pass
constexpr int kYinCols = kSynKT + 2 * (kMaxTaps - 1);

struct GlArgs {
    const float* mag;   // (B, T, F)
    const float* are;   // angles in
    const float* aim;
    const float* tre;   // previous projection in
    const float* tim;
    const float* env;   // (T + overlap - 1, hop), > 0
    const float* bcos;  // (hop, F)
    const float* bsin;
    const float* ict;   // (F, hop) inverse basis, hermitian weights folded in
    const float* ist;
    const float* twr;   // (overlap, F)
    const float* twi;
    float* nare;        // outputs (B, T, F)
    float* naim;
    float* rre;
    float* rim;
    float* scratch;     // (n_blocks, 4, tile_t + 2 m (chain - 1), F) or null
    long long B;
    int T, F, hop, overlap, chain, tile_t, n_tiles;
    int project;        // 1: write R only (tre, tim, nare, naim unused; chain 1)
    float mom;
    Taps taps;
};

__host__ __device__ inline int gl_sample_rows(int tile_t, int chain, int overlap) {
    return tile_t + 2 * (overlap - 1) * (chain - 1) + (overlap - 1);
}

__host__ __device__ constexpr int syn_work_floats() {
    return kSynK * kSynN + kRowGroup * kSynK + 2 * kMaxRows * kYinCols;
}

__global__ void __launch_bounds__(kThreads) gl_step_kernel(GlArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    const int F = a.F, T = a.T, hop = a.hop, ov = a.overlap, m = a.overlap - 1;
    const int N = F - 1;
    const int P = a.taps.P;

    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int tile = (int)(blk - b * a.n_tiles);
    const int t0 = tile * a.tile_t;
    const int H = m * (a.chain - 1);     // widest output halo
    const int Wmax = a.tile_t + 2 * H;   // scratch rows

    float* samples = smem;  // [gl_sample_rows][hop]
    float* work = samples + (size_t)gl_sample_rows(a.tile_t, a.chain, ov) * hop;
    // synthesis view of the work area
    float* Bs = work;                         // [kSynK][kSynN]
    float* As = Bs + kSynK * kSynN;           // [kRowGroup][kSynK]
    float* Yre = As + kRowGroup * kSynK;      // [kMaxRows][kYinCols]
    float* Yim = Yre + kMaxRows * kYinCols;
    // analysis view of the same area
    AnaWork w = carve_ana(work);

    const size_t bofs = (size_t)b * T * F;
    float* scr_are = a.scratch ? a.scratch + (size_t)blk * 4 * Wmax * F : nullptr;
    float* scr_aim = scr_are ? scr_are + (size_t)Wmax * F : nullptr;
    float* scr_rre = scr_are ? scr_aim + (size_t)Wmax * F : nullptr;
    float* scr_rim = scr_are ? scr_rre + (size_t)Wmax * F : nullptr;
    const int scr_f0 = t0 - H;  // frame of scratch row 0

    for (int it = 0; it < a.chain; ++it) {
        const int halo = m * (a.chain - 1 - it);
        const int fa = t0 - halo;              // first output frame of this iteration
        const int Wi = a.tile_t + 2 * halo;    // output frames
        const int nch = Wi + m;                // chunks fa .. fa + nch - 1
        const bool first = it == 0;
        const bool last = it == a.chain - 1;
        const float* in_re = first ? a.are + bofs : scr_are;
        const float* in_im = first ? a.aim + bofs : scr_aim;

        // ---- synthesis: spectrogram window -> time samples of its chunks ----
        for (int g0 = 0; g0 < nch; g0 += kRowGroup) {
            const int gn = min(kRowGroup, nch - g0);  // chunk rows of this group
            const int f_first = fa + g0 - m;          // frame of Y row 0
            for (int nc0 = 0; nc0 < hop; nc0 += kSynN) {
                float acc[4][8];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int q = 0; q < 8; ++q) acc[i][q] = 0.0f;

                // Operands of the next bin tile are loaded into registers
                // before the current tile is multiplied, so their latency
                // hides behind the FMAs.  A thread stages its own column of
                // the inverse basis (rows k0.. of [re | im]) and its share of
                // Y = mag * angles on the hermitian extension (frames
                // f_first .. f_first + gn + m - 1, columns k0 - P ..).
                static_assert(kSynN == kThreads, "one staged column per thread");
                const bool col_ok = nc0 + tid < hop;
                const size_t col = col_ok ? nc0 + tid : 0;
                const int ycols = kSynKT + 2 * P;
                const int n_y = (gn + m) * ycols;
                constexpr int kYPer = (kMaxRows * kYinCols + kThreads - 1) / kThreads;
                float vb[kSynK];
                float mg[kYPer], vr[kYPer], vi[kYPer], sg[kYPer];
                auto fetch = [&](int k0) {
#pragma unroll
                    for (int kk = 0; kk < kSynK; ++kk) {
                        int k = k0 + (kk < kSynKT ? kk : kk - kSynKT);
                        const float* src = kk < kSynKT ? a.ict : a.ist;
                        vb[kk] = __ldg(src + (size_t)(k < F ? k : 0) * hop + col);
                    }
#pragma unroll
                    for (int i = 0; i < kYPer; ++i) {
                        int idx = tid + i * kThreads;
                        int r = idx / ycols;
                        int c = idx - r * ycols;
                        int f = f_first + r;
                        int bin;
                        reflect_bin(k0 - P + c, N, &bin, &sg[i]);
                        bool ok = idx < n_y && f >= 0 && f < T && bin >= 0;
                        // the nyquist bin of a real signal's spectrum is real
                        if (bin == N) sg[i] = 0.0f;
                        if (!ok) { bin = 0; f = first ? 0 : scr_f0; }
                        size_t o = first ? (size_t)f * F + bin : (size_t)(f - scr_f0) * F + bin;
                        mg[i] = ok ? a.mag[bofs + (size_t)f * F + bin] : 0.0f;
                        vr[i] = ok ? in_re[o] : 0.0f;
                        vi[i] = ok ? in_im[o] : 0.0f;
                    }
                };
                fetch(0);
                for (int k0 = 0; k0 < F; k0 += kSynKT) {
                    __syncthreads();  // previous tile's operands consumed
#pragma unroll
                    for (int kk = 0; kk < kSynK; ++kk) {
                        int k = k0 + (kk < kSynKT ? kk : kk - kSynKT);
                        Bs[kk * kSynN + tid] = (k < F && col_ok) ? vb[kk] : 0.0f;
                    }
#pragma unroll
                    for (int i = 0; i < kYPer; ++i) {
                        int idx = tid + i * kThreads;
                        if (idx < n_y) {
                            int r = idx / ycols;
                            int c = idx - r * ycols;
                            Yre[r * kYinCols + c] = mg[i] * vr[i];
                            Yim[r * kYinCols + c] = sg[i] * mg[i] * vi[i];
                        }
                    }
                    __syncthreads();
                    if (k0 + kSynKT < F) fetch(k0 + kSynKT);
                    // D[rc][k] = sum_j conj(tw_j[k]) taps_conv(Y)[rc + m - j][k]
                    for (int idx = tid; idx < kRowGroup * kSynKT; idx += kThreads) {
                        int rc = idx / kSynKT;
                        int c = idx - rc * kSynKT;
                        int k = k0 + c;
                        float dr = 0.0f, di = 0.0f;
                        if (rc < gn && k < F) {
                            for (int j = 0; j < ov; ++j) {
                                const float* yr = Yre + (rc + m - j) * kYinCols + c + P;
                                const float* yi = Yim + (rc + m - j) * kYinCols + c + P;
                                float re = a.taps.c[0] * yr[0];
                                float im = a.taps.c[0] * yi[0];
                                for (int p = 1; p <= P; ++p) {
                                    re += a.taps.c[p] * (yr[-p] + yr[p]);
                                    im += a.taps.c[p] * (yi[-p] + yi[p]);
                                }
                                float wr = __ldg(a.twr + (size_t)j * F + k);
                                float wi = __ldg(a.twi + (size_t)j * F + k);
                                dr += wr * re + wi * im;
                                di += wr * im - wi * re;
                            }
                        }
                        As[rc * kSynK + c] = dr;
                        As[rc * kSynK + kSynKT + c] = di;
                    }
                    __syncthreads();
                    if (ty * 4 >= gn) continue;  // this warp's chunk rows are all padding
#pragma unroll 2
                    for (int kk = 0; kk < kSynK; kk += 4) {
                        float4 av[4];
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            av[i] = *reinterpret_cast<const float4*>(
                                As + (ty * 4 + i) * kSynK + kk);
                        }
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            // a lane owns sample columns 4 tx .. 4 tx + 3 and
                            // 128 + 4 tx .. : two conflict-free float4 loads
                            const float4 b0 = *reinterpret_cast<const float4*>(
                                Bs + (kk + u) * kSynN + tx * 4);
                            const float4 b1 = *reinterpret_cast<const float4*>(
                                Bs + (kk + u) * kSynN + 128 + tx * 4);
                            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                            for (int i = 0; i < 4; ++i) {
                                float x = u == 0 ? av[i].x
                                                 : (u == 1 ? av[i].y : (u == 2 ? av[i].z : av[i].w));
#pragma unroll
                                for (int q = 0; q < 8; ++q) {
                                    acc[i][q] = fmaf(x, bv[q], acc[i][q]);
                                }
                            }
                        }
                    }
                }
                // / envelope -> samples of chunks fa + g0 + rc
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    int rc = ty * 4 + i;
                    if (rc < gn) {
                        int c_abs = fa + g0 + rc;
                        bool in_sig = c_abs >= 0 && c_abs < T + m;
#pragma unroll
                        for (int q = 0; q < 8; ++q) {
                            int n = nc0 + (q < 4 ? 0 : 128) + tx * 4 + (q & 3);
                            if (n < hop) {
                                float e = in_sig ? __ldg(a.env + (size_t)c_abs * hop + n) : 1.0f;
                                samples[(size_t)(g0 + rc) * hop + n] = acc[i][q] / e;
                            }
                        }
                    }
                }
            }
        }
        __syncthreads();

        // ---- analysis: samples -> projected spectrum, momentum update ----
        const int useful = kColTile - 2 * P;
        const int n_ct = n_col_tiles(F, P);
        for (int g0 = 0; g0 < Wi; g0 += kRowGroup) {
            const int gn = min(kRowGroup, Wi - g0);
            for (int ct = 0; ct < n_ct; ++ct) {
                analysis_tile(samples + (size_t)g0 * hop, gn + m, gn, hop, ov, F, ct, P,
                              a.bcos, a.bsin, a.twr, a.twi, w);
                const int k0 = ct * useful;
                // in batches of four elements: the previous projection's
                // loads first (independent, in flight together), then the
                // update and the stores
                constexpr int kEB = 4;
                for (int base = tid; base < gn * useful; base += kThreads * kEB) {
                    float tp_re[kEB], tp_im[kEB];
                    size_t og[kEB], os[kEB];
                    bool ok[kEB];
#pragma unroll
                    for (int e = 0; e < kEB; ++e) {
                        int idx = base + e * kThreads;
                        int t = idx / useful;
                        int k = k0 + (idx - t * useful);
                        int f = fa + g0 + t;
                        ok[e] = idx < gn * useful && k < F && f >= 0 && f < T;
                        og[e] = ok[e] ? bofs + (size_t)f * F + k : 0;
                        os[e] = ok[e] ? (size_t)(f - scr_f0) * F + k : 0;
                        const bool rd = ok[e] && !a.project;
                        tp_re[e] = !rd ? 0.0f : (first ? a.tre[og[e]] : scr_rre[os[e]]);
                        tp_im[e] = !rd ? 0.0f : (first ? a.tim[og[e]] : scr_rim[os[e]]);
                    }
#pragma unroll
                    for (int e = 0; e < kEB; ++e) {
                        if (!ok[e]) continue;
                        int idx = base + e * kThreads;
                        int t = idx / useful;
                        int cu = idx - t * useful;
                        float r_re, r_im;
                        taps_at(w, a.taps, t, cu + P, &r_re, &r_im);
                        if (a.project) {
                            a.rre[og[e]] = r_re;
                            a.rim[og[e]] = r_im;
                            continue;
                        }
                        float ure = r_re - a.mom * tp_re[e];
                        float uim = r_im - a.mom * tp_im[e];
                        float nrm = fmaxf(sqrtf(ure * ure + uim * uim), 1e-16f);
                        if (last) {
                            a.rre[og[e]] = r_re;
                            a.rim[og[e]] = r_im;
                            a.nare[og[e]] = ure / nrm;
                            a.naim[og[e]] = uim / nrm;
                        } else {
                            scr_rre[os[e]] = r_re;
                            scr_rim[os[e]] = r_im;
                            scr_are[os[e]] = ure / nrm;
                            scr_aim[os[e]] = uim / nrm;
                        }
                    }
                }
            }
        }
        __syncthreads();  // scratch and samples settled before the next iteration
    }
}

static size_t gl_smem_bytes(int tile_t, int chain, int overlap, int hop) {
    size_t work = syn_work_floats() > ana_work_floats() ? syn_work_floats() : ana_work_floats();
    return ((size_t)gl_sample_rows(tile_t, chain, overlap) * hop + work) * sizeof(float);
}

// ------------------------------------------------------------ the FFT route
struct GlFftArgs {
    const float* mag;     // (B, T, F)
    const float* are;     // angles in
    const float* aim;
    const float* tre;     // previous projection in (not read by the projection alone)
    const float* tim;
    const float* env;     // (T + overlap - 1, hop), > 0
    const float* win;     // (n_fft,) analysis window
    const float* wsyn;    // (n_fft,) synthesis window / n_fft
    const float* leak;    // (n_fft,) -(2 / n_fft) sum_{p >= 1} taps[p] sin(2 pi p i / n_fft)
    const float* fft_tw;  // (2, n_fft) twiddle table
    float* nare;          // outputs (B, T, F) (nare, naim unused by the projection alone)
    float* naim;
    float* rre;
    float* rim;
    float* scratch;          // chain >= 2: (4, B, T, F), the state of every other iteration
    unsigned int* barrier;   // chain >= 2: the grid barrier's two counters, zeroed
    long long B;
    int T, F, hop, overlap, tile_t, n_tiles, teams, chain, project;
    float mom;
};

// The samples of tile_t + overlap - 1 chunks, frames_rfft's area on the
// route n takes (window, twiddles, teams' buffers: fft_area_floats), the
// synthesis window, the leak table, and one leak factor Im(Y_0) per
// synthesized frame.
__host__ __device__ inline size_t gl_fft_smem_floats(int tile_t, int overlap, int hop, int teams) {
    const int n = overlap * hop;
    return (size_t)(tile_t + overlap - 1) * hop + fft_area_floats(n, teams) + 2 * (size_t)n +
           (size_t)tile_t + 2 * overlap;
}

// A barrier across all blocks of a cooperative launch (every block resident):
// bar[0] counts arrivals, bar[1] is the generation.  A block that waits on
// the order of ten seconds traps, so a launch that lost residency fails
// instead of hanging the card.
__device__ void gl_grid_sync(unsigned int* bar) {
    __syncthreads();
    if (threadIdx.x == 0) {
        volatile unsigned int* gen_p = bar + 1;
        const unsigned int gen = *gen_p;
        __threadfence();
        if (atomicAdd(bar, 1u) == gridDim.x - 1) {
            atomicExch(bar, 0u);
            __threadfence();
            atomicAdd(bar + 1, 1u);
        } else {
            unsigned int spins = 0;
            while (*gen_p == gen) {
                __nanosleep(64);
                if (++spins == (1u << 27)) __trap();
            }
        }
        __threadfence();
    }
    __syncthreads();
}

// C, D and I on the FFT route (kSmooth = false) or the smooth route (kSmooth:
// the mixed-radix stages; with kSeven the radix-7 stage too; see the note at
// the top).  Iteration it reads the
// inputs (it = 0) or iteration it - 1's state and writes the outputs when
// chain - 1 - it is even, the scratch set otherwise; state written during the
// launch is read with __ldcg (L2), never through L1 or the read-only path.
template <bool kSmooth, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, 2) gl_step_fft_kernel(GlFftArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int T = a.T, F = a.F, hop = a.hop, ov = a.overlap;
    const int n = ov * hop;
    const int R = a.tile_t + ov - 1;  // chunks of samples a tile holds
    float* samples = smem;            // [R][hop]
    const FftSmem fs = carve_fft<kSmooth, kSeven>(samples + (size_t)R * hop, n);
    float* wsyn = fs.buf + (size_t)a.teams * fft_buf_floats_of<kSmooth>(n);
    float* leak = wsyn + n;
    float* lam = leak + n;            // [tile_t + 2 overlap]
    fft_stage<kSmooth, kSeven>(a.win, a.fft_tw, fs, n);
    for (int i = threadIdx.x; i < n; i += kThreads) {
        wsyn[i] = __ldg(a.wsyn + i);
        leak[i] = __ldg(a.leak + i);
    }
    const size_t plane = (size_t)a.B * T * F;
    const long long n_work = a.B * a.n_tiles;
    const float mom = a.mom;
    // this iteration's state in (s_*) and out (d_*)
    const float *s_are = a.are, *s_aim = a.aim, *s_tre = a.tre, *s_tim = a.tim;
    for (int it = 0; it < a.chain; ++it) {
        const bool to_out = ((a.chain - 1 - it) & 1) == 0;
        float* d_are = to_out ? a.nare : a.scratch;
        float* d_aim = to_out ? a.naim : a.scratch + plane;
        float* d_rre = to_out ? a.rre : a.scratch + 2 * plane;
        float* d_rim = to_out ? a.rim : a.scratch + 3 * plane;
        if (it > 0) gl_grid_sync(a.barrier);
        for (long long wk = blockIdx.x; wk < n_work; wk += gridDim.x) {
            const long long b = wk / a.n_tiles;
            const int t0 = (int)(wk - b * a.n_tiles) * a.tile_t;
            const size_t bofs = (size_t)b * T * F;
            const int f0 = t0 - ov;  // local frame r is frame f0 + r
            const int n_fr = min(a.tile_t + 2 * ov, T - f0);
            // the previous tile's frames_rfft ended with a barrier
            for (int i = threadIdx.x; i < R * hop; i += kThreads) samples[i] = 0.0f;
            for (int r = threadIdx.x; r < n_fr; r += kThreads) {
                const int f = f0 + r;
                const size_t o = bofs + (size_t)f * F;
                lam[r] = f >= 0 ? __fmul_rn(__ldg(a.mag + o), __ldcg(s_aim + o)) : 0.0f;
            }
            // frames_irfft starts with a barrier and ends with one
            frames_irfft<kSmooth, kSeven>(
                n_fr, ov, n, fs, wsyn, a.teams,
                [&](int r, int k, float& re, float& im) {
                    const int f = f0 + r;
                    if (f < 0) {
                        re = 0.0f;
                        im = 0.0f;
                        return;
                    }
                    const size_t o = bofs + (size_t)f * F + k;
                    const float mg = __ldg(a.mag + o);
                    re = __fmul_rn(mg, __ldcg(s_are + o));
                    im = __fmul_rn(mg, __ldcg(s_aim + o));
                },
                [&](int r, int i, float v) {
                    const int f = f0 + r;
                    const int pos = (f - t0) * hop + i;
                    if (f >= 0 && pos >= 0 && pos < R * hop) {
                        samples[pos] = __fadd_rn(samples[pos], __fadd_rn(v, __fmul_rn(lam[r], leak[i])));
                    }
                });
            for (int i = threadIdx.x; i < R * hop; i += kThreads) {
                const int q = i / hop;
                const int c = t0 + q;  // chunk of the un-trimmed signal
                if (c < T + ov - 1) samples[i] = __fdiv_rn(samples[i], __ldg(a.env + (size_t)c * hop + (i - q * hop)));
            }
            // frames_rfft starts with a barrier and ends with one
            frames_rfft<kSmooth, kSeven>(samples, min(a.tile_t, T - t0), hop, n, fs, a.teams,
                        [&](int r, int k, float r_re, float r_im) {
                            const size_t o = bofs + (size_t)(t0 + r) * F + k;
                            d_rre[o] = r_re;
                            d_rim[o] = r_im;
                            if (a.project) return;
                            const float ure = __fsub_rn(r_re, __fmul_rn(mom, __ldcg(s_tre + o)));
                            const float uim = __fsub_rn(r_im, __fmul_rn(mom, __ldcg(s_tim + o)));
                            const float nrm = fmaxf(
                                __fsqrt_rn(__fadd_rn(__fmul_rn(ure, ure), __fmul_rn(uim, uim))), 1e-16f);
                            d_are[o] = __fdiv_rn(ure, nrm);
                            d_aim[o] = __fdiv_rn(uim, nrm);
                        });
        }
        s_are = d_are;
        s_aim = d_aim;
        s_tre = d_rre;
        s_tim = d_rim;
    }
}

// One launch of the route's instance: chain 1 a block a tile, a chain one
// cooperative launch of at most the blocks the card holds at once, sized by
// this instance's own occupancy (the grid barrier needs every block
// resident).
template <bool kSmooth, bool kSeven = false>
static cudaError_t gl_fft_launch(GlFftArgs a, size_t smem, cudaStream_t s) {
    const void* fn = (const void*)gl_step_fft_kernel<kSmooth, kSeven>;
    cudaError_t err = cudaFuncSetAttribute(gl_step_fft_kernel<kSmooth, kSeven>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const long long n_work = a.B * a.n_tiles;
    if (a.chain == 1) {
        gl_step_fft_kernel<kSmooth, kSeven><<<(unsigned)n_work, kThreads, smem, s>>>(a);
        return cudaGetLastError();
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_step_fft_kernel<kSmooth, kSeven>, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long resident = (long long)per_sm * sms;
    const unsigned grid = (unsigned)(n_work < resident ? n_work : resident);
    if ((err = cudaMemsetAsync(a.barrier, 0, 2 * sizeof(unsigned int), s)) != cudaSuccess) return err;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, smem, s);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace att

extern "C" {

// Shared memory one block needs for (tile_t, chain, overlap, hop).
long long att_gl_smem_bytes(int tile_t, int chain, int overlap, int hop) {
    return (long long)att::gl_smem_bytes(tile_t, chain, overlap, hop);
}

static int gl_launch(const float* mag, const float* are, const float* aim, const float* tre,
                     const float* tim, const float* env, long long B, int T, int F, int hop,
                     int overlap, const float* bcos, const float* bsin, const float* ict,
                     const float* ist, const float* twr, const float* twi,
                     const float* taps_host, int P, float mom, int chain, int tile_t, int project,
                     float* nare, float* naim, float* rre, float* rim, float* scratch,
                     void* stream) {
    using namespace att;
    if (P < 0 || P >= kMaxTaps || overlap < 2 || kRowGroup + overlap - 1 > kMaxRows ||
        hop % kKC != 0 || chain < 1 || tile_t < 1 || (chain >= 2 && scratch == nullptr) ||
        (project && chain != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    GlArgs a;
    a.mag = mag; a.are = are; a.aim = aim; a.tre = tre; a.tim = tim; a.env = env;
    a.bcos = bcos; a.bsin = bsin; a.ict = ict; a.ist = ist; a.twr = twr; a.twi = twi;
    a.nare = nare; a.naim = naim; a.rre = rre; a.rim = rim;
    a.scratch = chain >= 2 ? scratch : nullptr;
    a.B = B; a.T = T; a.F = F; a.hop = hop; a.overlap = overlap; a.chain = chain;
    a.tile_t = tile_t; a.n_tiles = (T + tile_t - 1) / tile_t; a.mom = mom;
    a.project = project;
    for (int i = 0; i < kMaxTaps; ++i) a.taps.c[i] = i <= P ? taps_host[i] : 0.0f;
    a.taps.P = P;

    size_t smem = gl_smem_bytes(tile_t, chain, overlap, hop);
    cudaError_t err = cudaFuncSetAttribute(
        gl_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(B * a.n_tiles));
    gl_step_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// All spectrogram arrays (B, T, F) float32 contiguous; outputs must not alias
// inputs.  Returns a cudaError_t.
int att_gl_step(const float* mag, const float* are, const float* aim, const float* tre,
                const float* tim, const float* env, long long B, int T, int F, int hop,
                int overlap, const float* bcos, const float* bsin, const float* ict,
                const float* ist, const float* twr, const float* twi, const float* taps_host,
                int P, float mom, int chain, int tile_t, float* nare, float* naim, float* rre,
                float* rim, float* scratch, void* stream) {
    return gl_launch(mag, are, aim, tre, tim, env, B, T, F, hop, overlap, bcos, bsin, ict, ist,
                     twr, twi, taps_host, P, mom, chain, tile_t, 0, nare, naim, rre, rim, scratch,
                     stream);
}

// Kernel I: the consistency projection R of mag * (are + i aim) alone, one
// iteration, same arrays and rules as att_gl_step.  Returns a cudaError_t.
int att_gl_project(const float* mag, const float* are, const float* aim, const float* env,
                   long long B, int T, int F, int hop, int overlap, const float* bcos,
                   const float* bsin, const float* ict, const float* ist, const float* twr,
                   const float* twi, const float* taps_host, int P, int tile_t, float* rre,
                   float* rim, void* stream) {
    return gl_launch(mag, are, aim, nullptr, nullptr, env, B, T, F, hop, overlap, bcos, bsin, ict,
                     ist, twr, twi, taps_host, P, 0.0f, 1, tile_t, 1, nullptr, nullptr, rre, rim,
                     nullptr, stream);
}

// Shared memory of one block of the FFT or the smooth route (the one n_fft =
// overlap hop takes): tile_t frames, `teams` FFTs side by side.
long long att_gl_fft_smem_bytes(int tile_t, int overlap, int hop, int teams) {
    return (long long)(att::gl_fft_smem_floats(tile_t, overlap, hop, teams) * sizeof(float));
}

// Kernels C (chain 1), D (chain >= 2) and I (project = 1, chain 1) on the FFT
// route, or on the smooth route where fft_covers_smooth7(n_fft) (the radix-7
// instance where n_fft has a factor 7).  Spectrogram
// arrays (B, T, F) float32 contiguous, outputs not aliasing inputs; env (T +
// overlap - 1, hop); n_fft = overlap hop a power of two from 64 to 4096 (1 <=
// teams <= 4096 / n_fft) or even, 2^a 3^b 5^c 7^d, 64 to 4096 (1 <= teams <=
// fft_smooth_max_teams(n_fft)), F = n_fft / 2 + 1; window, wsyn and leak
// (n_fft,) (the window, the window / n_fft (frames_fft.irfft_window; on the
// smooth route rounded once from float64), -(2 / n_fft) sum_{p >= 1} taps[p]
// sin(2 pi p i / n_fft)), fft_tw (2, n_fft) = (cos, -sin)(2 pi j / n_fft);
// tile_t a multiple of 2 overlap.  chain >= 2 needs scratch (4, B,
// T, F) and barrier (two unsigned ints, zeroed here on the stream) and is a
// cooperative launch of at most as many blocks as the card holds at once.
// project = 1: tre, tim, nare and naim are not used.  Returns a cudaError_t.
int att_gl_step_fft(const float* mag, const float* are, const float* aim, const float* tre,
                    const float* tim, const float* env, const float* window, const float* wsyn,
                    const float* leak, const float* fft_tw, long long B, int T, int F, int hop,
                    int overlap, int tile_t, int teams, float mom, int chain, int project,
                    float* nare, float* naim, float* rre, float* rim, float* scratch,
                    unsigned int* barrier, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool smooth = !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (B < 1 || T < 1 || overlap < 2 || (smooth && !fft_covers_smooth7(n_fft)) || F != n_fft / 2 + 1 ||
        teams < 1 || teams > max_teams || tile_t < 1 || tile_t % (2 * overlap) != 0 || chain < 1 ||
        (chain >= 2 && (scratch == nullptr || barrier == nullptr)) || (project && chain != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    GlFftArgs a = {};
    a.mag = mag; a.are = are; a.aim = aim; a.tre = tre; a.tim = tim; a.env = env;
    a.win = window; a.wsyn = wsyn; a.leak = leak; a.fft_tw = fft_tw;
    a.nare = nare; a.naim = naim; a.rre = rre; a.rim = rim; a.scratch = scratch; a.barrier = barrier;
    a.B = B; a.T = T; a.F = F; a.hop = hop; a.overlap = overlap; a.tile_t = tile_t;
    a.n_tiles = (T + tile_t - 1) / tile_t; a.teams = teams; a.chain = chain; a.project = project;
    a.mom = mom;
    const size_t smem = gl_fft_smem_floats(tile_t, overlap, hop, teams) * sizeof(float);
    cudaStream_t s = (cudaStream_t)stream;
    if (seven) return (int)gl_fft_launch<true, true>(a, smem, s);
    return (int)(smooth ? gl_fft_launch<true>(a, smem, s) : gl_fft_launch<false>(a, smem, s));
}

}  // extern "C"
