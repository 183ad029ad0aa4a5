// Fused mel-spectrogram forward and fit statistics for Hopper (sm_90a).
//
// Replaces, from the JAX package's ops/pallas/spectral.py:
//   melspec_forward_kernel<.., kFrontFactored>  <- _forward_kernel_factored  (via _fused_call /
//                                      fused_melspec; where n_fft is a power of two from
//                                      64 to 4096 the wrapper sends it to the kFrontFft
//                                      instance, where it is even and 5-smooth to the
//                                      kFrontSmooth one, where it is even and 7-smooth with
//                                      a factor 7 to the kFrontSmooth7 one, under the taps'
//                                      own window)
//   melspec_stats_kernel<.., kFrontFactored>    <- _stats_kernel_factored    (via _stats_call /
//                                      fused_melspec_stats; the same rule)
//   melspec_forward_kernel<.., kFrontFft / kFrontSmooth / kFrontSmooth7 / kFrontProduct>
//                                      <- _forward_kernel (full-K: any window, taps=None)
//   melspec_stats_kernel<.., kFrontFft / kFrontSmooth / kFrontSmooth7 / kFrontProduct>
//                                      <- _stats_kernel (full-K)
//   repr_forward_kernel<.., kFrontFactored> <- _repr_kernel_factored (via _repr_call /
//                                     fused_spectral_repr), epilogue _repr_channels; A's
//                                     rule: the kFrontFft instance at a power of two, the
//                                     kFrontSmooth one at an even 5-smooth n_fft, the
//                                     kFrontSmooth7 one at an even 7-smooth n_fft with a
//                                     factor 7, under the taps' own window)
//   repr_forward_kernel<.., kFrontFft / kFrontSmooth / kFrontSmooth7 / kFrontProduct>
//                                     <- _repr_kernel (full-K)
//   repr_stats_kernel<.., kFrontFactored>   <- _repr_stats_kernel_factored (via
//                                     _repr_stats_call / fused_repr_stats; the same rule)
//   repr_stats_kernel<.., kFrontFft / kFrontSmooth / kFrontSmooth7 / kFrontProduct>
//                                     <- _repr_stats_kernel (full-K)
//   stats_reduce_kernel     <- the accumulation the TPU kernel carried across its
//                              sequential grid (_stats_update)
//   melspec_stage_kernel<kStage> <- the stage-prefix kernel of
//                              tools/sweep_kernel_floor.py (its pallas_call at
//                              :110): melspec_forward_kernel<false, false,
//                              kFrontFactored> cut after one of its stages
//
// The full-K kernels differ from the factored ones only before the magnitude
// (one epilogue, four front ends): frame t is the slice row[t hop, t hop +
// n_fft) of the same padded rows.  Where n_fft is a power of two from 64 to
// 4096 (fft_smem.cuh:fft_covers) the full-K kernels (E, F, G, H) take the
// FFT route, kFrontFft: fft_smem.cuh:frames_rfft over the block's frames (the
// window and the twiddle table staged once a block, no basis read), its
// epilogue handed every bin of a frame pair.  Where n_fft is even and
// 2^a 3^b 5^c, 64 to 4096 and no power of two (fft_covers_smooth: 768, 640,
// 1536, 1920, ...) E, F, G and H (and so A, B and G and H with taps) take the
// smooth route, kFrontSmooth: the same with frames_rfft<true>, the
// mixed-radix stages.  Where n_fft is even and 2^a 3^b 5^c 7^d with a factor
// 7 (fft_covers_smooth7: 896, 1344, 1568, ...) E, F, G and H (so A, B and G
// and H with taps) take the smooth route's radix-7 instance, kFrontSmooth7
// (frames_rfft<true, true>), wherever the wrapper finds a block that fits
// (G with the IF and a mel bank at 4032/2016 keeps the product route).
// Otherwise the product route,
// kFrontProduct: a window-folded basis of n_fft x F (cos |
// -sin), all F bins in one fp32 product; the contraction is n_fft long
// instead of hop, so it does `overlap` times the multiply-adds of the
// factored kernels.  That basis (4.2 MB at n_fft 1024) stays in L2 and is
// streamed through shared memory in chunks of 32 rows like the chunk basis.
//
// What bounds them on this card: the function itself is bound by bytes (an
// FFT needs about 2.5 n_fft log2 n_fft operations per frame, far below the
// fp32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 flop/byte).  This design is
// not: it keeps the chunk-DFT product of the kernel it replaces, 2 * hop * F
// fp32 multiply-adds per chunk (0.26 M at hop 256, F 513) against 4 * hop
// bytes read and 4 * M bytes written, about 85 flop per byte, so its own
// ceiling is the card's fp32 FMA rate.
//
// Design: a block owns one batch row and `tile_t` frames: 32, or 16 or 8
// where 32 frames of magnitudes do not fit shared memory (n_fft 2048 and
// 4096); the wrapper picks.  It loads the tile_t + overlap - 1 hop chunks
// once into shared memory (int16 PCM is converted
// there, x * 2^-15, so the result is bit-identical to pre-converted float
// input), runs the chunk DFT in column tiles of 128 bins (halo included)
// with the basis staged through shared memory one chunk ahead of the
// multiply-adds, combines with the twiddles, applies the
// window as the hermitian taps conv and keeps the (tile_t, F) magnitudes in
// shared memory.  The mel product then reads them from there: the bank is
// banded, so each output column sums only over its nonzero rows [lo, hi),
// which equals the dense product.  Nothing but the input rows and the
// output leaves the SM.  The statistics kernel shares that front end and
// writes per-block partials (sum, sumsq, min, max per bin); a second small
// kernel reduces them in a fixed order in double precision, so the result
// is deterministic (no float atomics).
//
// The representation kernels (Polar, PolarIF, Cartesian: two channels from
// one DFT) run the same two front ends and differ only after the complex
// spectrum of a column tile is in shared memory.  Channel 1 (|X|, or Re) and
// channel 2 (the atan2 phase, the instantaneous frequency, or Im) are formed
// per bin there; channel 1 goes to the (tile_t, F) shared buffer when the mel
// product needs whole rows, channel 2 straight to device memory, coalesced
// along the bins.  The IF needs the previous frame's phase: the TPU kernel
// carried the last phase row of a tile across its sequential grid, here a
// block recomputes one halo frame before its tile (the rows carry one leading
// zero chunk so that tile 0 has one too; frame 0 passes its raw angle
// through, so the halo of tile 0 is never read).  The nyquist bin's
// imaginary part is pinned to 0, so its angle is exactly 0 or pi as the TPU
// kernel sets it (the full-K product leaves a rounding-size part there,
// which would flip pi to -pi).  The fit statistics of both channels are
// reduced per column tile from shared memory, with channel 1 the non-mel
// contrasted magnitude (what Magnitude.fit fits on).
//
// The representation kernels' FFT and smooth routes (repr_forward_fft,
// repr_stats_fft; kSmooth runs frames_rfft<true>, the mixed-radix stages,
// kSeven their radix-7 stages too, and neither changes anything else) rearrange that epilogue around frames_rfft, which
// hands over every bin of a frame pair instead of one column tile of all
// frames; what it computes is unchanged.  Each bin is formed in the emit (the nyquist pin, the angle's
// rules); without a mel bank channel 1 goes straight to device memory, with
// one it waits in shared memory for the banded product (emit_mel_rows:
// emit_tile's sums, eight rows at a time); the IF's angles of the tile and
// its halo frame wait for a pass after the FFTs, and the statistics kernel
// folds both channels per column in frame order from shared memory.  The
// halo: frames_rfft pairs frames (2j, 2j + 1) of the block's numbering, so a
// block with the IF starts at frame t0 - 2 (t0 is even), two frames before
// its tile: the halo frame t0 - 1 then goes through the FFT with its partner
// t0 - 2 as in every other block and in the plain version (frames_rfft_
// reference over the whole clip), and rounds alike.  The rows carry two
// leading zero chunks for it.  The smooth route's frames_rfft<true, .> pairs
// the frames alike, whatever its radices, so the same rule holds there.  Every product and sum of the
// magnitude is rounded on its own (__fmul_rn / __fadd_rn), as the plain
// version has it.
//
// Arithmetic is fp32 FMA with fp32 accumulation: no tensor cores yet.  What
// keeps it from that ceiling: one block of 8 warps per SM (the magnitudes take
// 66 KB of shared memory at F = 513), so shared-memory latency is hidden by
// instruction-level parallelism only; 128-column tiles cover 513 bins with
// 20 % waste, 40-row tiles hold 35 rows.
//
// The floor sweep (melspec_stage_kernel, ops/cuda/spectral.py:
// melspec_forward_stage) times A cut after each of its stages, one
// instantiation a stage, with A's grid, threads and shared memory, so that
// each increment is that stage's share of A's time.  Each prefix stores a
// value that depends on all of its work (nothing is dead to the compiler);
// the shipped kernels are the kStageFull instantiations, the same code as
// without the cut.
#include <cuda_bf16.h>
#include <math.h>

#include "dft_common.cuh"
#include "fft_smem.cuh"

namespace att {

// Front ends of the melspec kernels
constexpr int kFrontFactored = 0;  // chunk product, twiddle combine, taps conv (A, B)
constexpr int kFrontProduct = 1;   // window-folded n_fft x F product (E, F where no FFT covers)
constexpr int kFrontFft = 2;       // frames_rfft (E, F at a power of two n_fft, 64 .. 4096)
constexpr int kFrontSmooth = 3;    // frames_rfft<true> (E, F at an even 5-smooth n_fft, no power of two)
constexpr int kFrontSmooth7 = 4;   // frames_rfft<true, true> (E, F, G, H at an even 7-smooth n_fft with a factor 7)

// the front ends that run frames_rfft
__host__ __device__ constexpr bool front_is_fft(int front) {
    return front == kFrontFft || front == kFrontSmooth || front == kFrontSmooth7;
}

// the front ends that run the mixed-radix frames_rfft<true, .>
__host__ __device__ constexpr bool front_is_smooth(int front) {
    return front == kFrontSmooth || front == kFrontSmooth7;
}

// What the FFT route reads: the window (n_fft,) and the twiddle table (2,
// n_fft), both on the device, and the FFTs a block runs side by side.
struct FftArgs {
    const float* win;
    const float* tw;
    int teams;
};

// Stages of the floor sweep, numbered as the JAX tool's (its s2, a bf16x3
// product, has no counterpart: this product is one fp32 pass).  Each adds
// one piece of A to the previous one; kStageMelDense is kStageMel with the
// dense product.
constexpr int kStageCopy = 0;      // rows into shared memory; store the block's first sample
constexpr int kStageDots = 1;      // + chunk product; store Cre + Cim of the tile's chunks
constexpr int kStageCombine = 3;   // + twiddle combine, centre tap only, power
constexpr int kStageTaps = 4;      // + the neighbour taps, power
constexpr int kStageMag = 5;       // + sqrt (A's power)
constexpr int kStageMel = 6;       // + banded mel product
constexpr int kStageFull = 7;      // + contrast and affine: A
constexpr int kStageMelDense = 8;  // kStageMel over every row of the bank

// n_rows hop chunks from row row0 of the prepared rows into xs (int16 PCM
// converted here, x * 2^-15, exact), then a barrier.
template <bool kInt16>
__device__ void load_rows(const void* __restrict__ x_rows, size_t row0, int n_rows, int hop,
                          float* xs) {
    const size_t n_el = (size_t)n_rows * hop;
    if (kInt16) {
        const int16_t* src = reinterpret_cast<const int16_t*>(x_rows) + row0 * hop;
        for (size_t i = threadIdx.x; i < n_el; i += kThreads) {
            xs[i] = (float)src[i] * 3.0517578125e-05f;  // 2^-15, exact
        }
    } else {
        const float* src = reinterpret_cast<const float*>(x_rows) + row0 * hop;
        for (size_t i = threadIdx.x; i < n_el; i += kThreads) {
            xs[i] = src[i];
        }
    }
    __syncthreads();
}

// Magnitudes (or powers) of one block's tile_t frames into mag_s[t * F + k].
// The FFT and smooth routes compute only the block's first t_valid frames (the rest are
// tile padding, which nothing reads: its frame pairs with a zero frame as in
// frames_rfft_reference); `work` is the area after mag_s (AnaWork, or the
// FFT's).  kStage < kStageMag cuts it short (see the stages above):
// kStageCopy only loads the rows, kStageDots stores Cre + Cim of the chunk
// product in place of the magnitudes, kStageCombine and kStageTaps the power.
template <bool kInt16, int kFront, int kStage = kStageFull>
__device__ void block_magnitudes(const void* __restrict__ x_rows, long long b, int tile,
                                 int tile_t, int n_rows_total, int hop, int overlap, int F,
                                 const float* bcos, const float* bsin, const float* twr,
                                 const float* twi, Taps taps, bool power2, float* xs,
                                 float* mag_s, float* work, FftArgs fft, int t_valid) {
    const int tid = threadIdx.x;
    const int n_rows = tile_t + overlap - 1;
    static_assert(kFront == kFrontFactored || kStage == kStageFull,
                  "the floor sweep cuts the factored front end");
    if constexpr (front_is_fft(kFront)) {
        constexpr bool kSmooth = front_is_smooth(kFront);
        constexpr bool kSeven = kFront == kFrontSmooth7;
        const int n_fft = overlap * hop;
        const FftSmem fs = carve_fft<kSmooth, kSeven>(work, n_fft);
        fft_stage<kSmooth, kSeven>(fft.win, fft.tw, fs, n_fft);  // load_rows' barrier covers it
        load_rows<kInt16>(x_rows, (size_t)b * n_rows_total + (size_t)tile * tile_t, n_rows, hop, xs);
        frames_rfft<kSmooth, kSeven>(xs, t_valid, hop, n_fft, fs, fft.teams, [&](int t, int k, float re, float im) {
            const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            mag_s[t * F + k] = power2 ? p : sqrtf(p);
        });  // frames_rfft ends with a barrier
    } else {
        const AnaWork w = carve_ana(work);
        load_rows<kInt16>(x_rows, (size_t)b * n_rows_total + (size_t)tile * tile_t, n_rows, hop, xs);
        if (kStage == kStageCopy) return;

        const int P = taps.P;
        const int useful = kColTile - 2 * P;
        const int n_ct = n_col_tiles(F, P);
        Taps conv = taps;  // kStageCombine: A's column tiles, the centre tap alone
        if (kStage == kStageCombine) conv.P = 0;
        const bool pow2 = kStage <= kStageTaps || power2;
        for (int ct = 0; ct < n_ct; ++ct) {
            if (kStage == kStageDots) {
                chunk_product(xs, n_rows, hop, F, ct, P, bcos, bsin, w);
                for (int idx = tid; idx < tile_t * useful; idx += kThreads) {
                    int t = idx / useful;
                    int cu = idx - t * useful;
                    int k = ct * useful + cu;
                    if (k < F) {
                        const int c = t * kColTile + cu + P;
                        mag_s[t * F + k] = w.Cre[c] + w.Cim[c];
                    }
                }
                continue;
            }
            if (kFront == kFrontProduct) {
                analysis_tile(xs, tile_t, tile_t, hop, overlap, F, ct, P, bcos, bsin, twr, twi, w,
                              overlap * hop);
            } else {
                analysis_tile(xs, n_rows, tile_t, hop, overlap, F, ct, P, bcos, bsin, twr, twi, w);
            }
            const int k0 = ct * useful;
            for (int idx = tid; idx < tile_t * useful; idx += kThreads) {
                int t = idx / useful;
                int cu = idx - t * useful;
                int k = k0 + cu;
                if (k < F) {
                    float re, im;
                    taps_at(w, conv, t, cu + P, &re, &im);
                    float p = re * re + im * im;
                    mag_s[t * F + k] = pow2 ? p : sqrtf(p);
                }
            }
        }
        __syncthreads();
    }
}

__device__ __forceinline__ float contrast_of(float v, int contrast) {
    return contrast == 1 ? log1pf(v) : v;
}

// Mel product (banded), contrast, affine and store of one block's kTile
// frames; a thread owns output columns and keeps its kTile sums in registers.
// Every stage but kStageFull stores the sums as they are (no contrast, no
// affine); kStageMelDense sums over every row of the bank.
template <int kTile, bool kBf16, int kStage = kStageFull>
__device__ void emit_tile(const float* mag_s, long long b, int t_base, int F, int T,
                          int contrast, const float* __restrict__ mel_bank,
                          const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
                          int M, float offset, float scale, void* __restrict__ out) {
    const int t_valid = min(kTile, T - t_base);
    const int n_out = mel_bank != nullptr ? M : F;
    for (int m = threadIdx.x; m < n_out; m += kThreads) {
        float acc[kTile];
        if (mel_bank != nullptr) {
#pragma unroll
            for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
            const int lo = kStage == kStageMelDense ? 0 : mel_lo[m];
            const int hi = kStage == kStageMelDense ? F : mel_hi[m];
            for (int f = lo; f < hi; ++f) {
                float bv = __ldg(mel_bank + (size_t)f * M + m);
#pragma unroll
                for (int t = 0; t < kTile; ++t) {
                    acc[t] = fmaf(mag_s[t * F + f], bv, acc[t]);
                }
            }
        } else {
#pragma unroll
            for (int t = 0; t < kTile; ++t) acc[t] = mag_s[t * F + m];
        }
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
            if (t < t_valid) {
                float y = kStage == kStageFull ? (contrast_of(acc[t], contrast) - offset) / scale
                                               : acc[t];
                size_t o = ((size_t)b * T + (t_base + t)) * n_out + m;
                if (kBf16) {
                    reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
                } else {
                    reinterpret_cast<float*>(out)[o] = y;
                }
            }
        }
    }
}

// On the FFT and smooth routes (the radix-7 instance too) at most 128
// registers a thread, so that two blocks share an SM where the wrapper's tile
// lets their shared memory (ops/cuda/spectral.py: _pick_fft_plan,
// _pick_smooth_plan).
template <bool kInt16, bool kBf16, int kFront>
__global__ void __launch_bounds__(kThreads, front_is_fft(kFront) ? 2 : 1)
melspec_forward_kernel(const void* __restrict__ x_rows, int n_tiles, int tile_t,
                       int n_rows_total, int hop, int overlap, int F, int T,
                       const float* bcos, const float* bsin, const float* twr,
                       const float* twi, Taps taps, int power2, int contrast,
                       const float* __restrict__ mel_bank, const int* __restrict__ mel_lo,
                       const int* __restrict__ mel_hi, int M, const float* __restrict__ aff,
                       void* __restrict__ out, FftArgs fft) {
    extern __shared__ __align__(16) float smem[];
    const int n_rows = tile_t + overlap - 1;
    float* xs = smem;
    float* mag_s = xs + (size_t)n_rows * hop;

    const long long blk = blockIdx.x;
    const long long b = blk / n_tiles;
    const int tile = (int)(blk - b * n_tiles);
    block_magnitudes<kInt16, kFront>(x_rows, b, tile, tile_t, n_rows_total, hop, overlap, F, bcos,
                                     bsin, twr, twi, taps, power2 != 0, xs, mag_s,
                                     mag_s + (size_t)tile_t * F, fft, min(tile_t, T - tile * tile_t));

    const float offset = aff[0];
    const float scale = aff[1];
    const int t_base = tile * tile_t;
    switch (tile_t) {
        case 32:
            if constexpr (front_is_smooth(kFront)) {
                // two halves of 16 frames: 32 sums a thread beside the smooth
                // FFT's code spilled 64 B at 128 registers (each frame's sum
                // runs over the bank's rows in the same order either way)
                emit_tile<16, kBf16>(mag_s, b, t_base, F, T, contrast, mel_bank, mel_lo, mel_hi, M,
                                     offset, scale, out);
                emit_tile<16, kBf16>(mag_s + (size_t)16 * F, b, t_base + 16, F, T, contrast, mel_bank,
                                     mel_lo, mel_hi, M, offset, scale, out);
            } else {
                emit_tile<32, kBf16>(mag_s, b, t_base, F, T, contrast, mel_bank, mel_lo, mel_hi, M,
                                     offset, scale, out);
            }
            break;
        case 16:
            emit_tile<16, kBf16>(mag_s, b, t_base, F, T, contrast, mel_bank, mel_lo, mel_hi, M,
                                 offset, scale, out);
            break;
        default:
            emit_tile<8, kBf16>(mag_s, b, t_base, F, T, contrast, mel_bank, mel_lo, mel_hi, M,
                                offset, scale, out);
    }
}

// A (float32 rows, float32 out, factored front end) cut after stage kStage.
// The stages up to kStageMag write (B, T, F), the later ones (B, T, M).
template <int kStage>
__global__ void __launch_bounds__(kThreads)
melspec_stage_kernel(const float* __restrict__ x_rows, int n_tiles, int tile_t,
                     int n_rows_total, int hop, int overlap, int F, int T, const float* bcos,
                     const float* bsin, const float* twr, const float* twi, Taps taps,
                     int power2, int contrast, const float* __restrict__ mel_bank,
                     const int* __restrict__ mel_lo, const int* __restrict__ mel_hi, int M,
                     const float* __restrict__ aff, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int n_rows = tile_t + overlap - 1;
    float* xs = smem;
    float* mag_s = xs + (size_t)n_rows * hop;

    const long long blk = blockIdx.x;
    const long long b = blk / n_tiles;
    const int tile = (int)(blk - b * n_tiles);
    block_magnitudes<false, kFrontFactored, kStage>(x_rows, b, tile, tile_t, n_rows_total, hop,
                                                    overlap, F, bcos, bsin, twr, twi, taps,
                                                    power2 != 0, xs, mag_s,
                                                    mag_s + (size_t)tile_t * F, FftArgs{}, tile_t);
    const int t_base = tile * tile_t;
    if (kStage == kStageCopy) {
        // zeros plus the block's first sample, stored as emit_tile stores
        const float v = 0.0f + xs[0];
        const int t_valid = min(tile_t, T - t_base);
        for (int k = threadIdx.x; k < F; k += kThreads) {
            for (int t = 0; t < t_valid; ++t) out[((size_t)b * T + (t_base + t)) * F + k] = v;
        }
        return;
    }
    const float* bank = kStage >= kStageMel ? mel_bank : nullptr;
    const float offset = aff[0];
    const float scale = aff[1];
    switch (tile_t) {
        case 32:
            emit_tile<32, false, kStage>(mag_s, b, t_base, F, T, contrast, bank, mel_lo, mel_hi,
                                         M, offset, scale, out);
            break;
        case 16:
            emit_tile<16, false, kStage>(mag_s, b, t_base, F, T, contrast, bank, mel_lo, mel_hi,
                                         M, offset, scale, out);
            break;
        default:
            emit_tile<8, false, kStage>(mag_s, b, t_base, F, T, contrast, bank, mel_lo, mel_hi,
                                        M, offset, scale, out);
    }
}

template <bool kInt16, int kFront>
__global__ void __launch_bounds__(kThreads, front_is_fft(kFront) ? 2 : 1)
melspec_stats_kernel(const void* __restrict__ x_rows, int n_tiles, int tile_t,
                     int n_rows_total, int hop, int overlap, int F, int T, const float* bcos, const float* bsin,
                     const float* twr, const float* twi, Taps taps, int contrast,
                     float* __restrict__ partials, FftArgs fft) {
    extern __shared__ __align__(16) float smem[];
    const int n_rows = tile_t + overlap - 1;
    float* xs = smem;
    float* mag_s = xs + (size_t)n_rows * hop;

    const long long blk = blockIdx.x;
    const long long b = blk / n_tiles;
    const int tile = (int)(blk - b * n_tiles);
    // frames past T are tile padding: they stay out of the statistics
    const int t_valid = min(tile_t, T - tile * tile_t);
    block_magnitudes<kInt16, kFront>(x_rows, b, tile, tile_t, n_rows_total, hop, overlap, F, bcos,
                                     bsin, twr, twi, taps, false, xs, mag_s,
                                     mag_s + (size_t)tile_t * F, fft, t_valid);

    float* dst = partials + (size_t)blk * 4 * F;
    for (int k = threadIdx.x; k < F; k += kThreads) {
        float s = 0.0f, ss = 0.0f, mn = INFINITY, mx = -INFINITY;
        for (int t = 0; t < t_valid; ++t) {
            float v = contrast_of(mag_s[t * F + k], contrast);
            s += v;
            ss = fmaf(v, v, ss);
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        }
        dst[k] = s;
        dst[F + k] = ss;
        dst[2 * F + k] = mn;
        dst[3 * F + k] = mx;
    }
}

// ---------------------------------------------------------------------------
// Two-channel representations (kernels G and H).

constexpr int kSecondPhase = 0;  // Polar:     ch1 |X| (mel, contrast), ch2 angle
constexpr int kSecondIF = 1;     // PolarIF:   ch1 as Polar, ch2 frame-local IF
constexpr int kSecondImag = 2;   // Cartesian: ch1 Re, ch2 Im
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvPi = 0.31830988618379067154f;

struct ReprArgs {
    const void* x_rows;   // (B, n_rows_total, hop): one leading zero chunk, then the padded signal
    int n_tiles, tile_t, n_rows_total, hop, overlap, F, T;
    const float* bcos;    // factored: (hop, F) chunk basis; full-K: (n_fft, F) windowed basis
    const float* bsin;
    const float* twr;     // factored only: (overlap, F) twiddles
    const float* twi;
    Taps taps;            // full-K: unit taps
    int second;           // kSecondPhase / kSecondIF / kSecondImag
    int weighted;         // IF: parabolic frame window of the global frame index
    int contrast;         // ch1: 0 none, 1 log1p (never for kSecondImag)
    const float* mel_bank;  // (F, F) or null
    const int* mel_lo;
    const int* mel_hi;
    const float* aff;     // [off1, scale1, off2, scale2]
    float* out1;          // (B, T, F)
    float* out2;          // (B, T, F)
    float* partials;      // statistics: (n_blocks, 8, F)
    FftArgs fft;          // FFT route: the window, the twiddle table, FFTs side by side
};

// Frames the FFT route computes before a block's tile: the IF's halo frame
// t0 - 1 and its partner t0 - 2.
__host__ __device__ inline int repr_fft_halo(int second) { return second == kSecondIF ? 2 : 0; }

// Rows of F floats the FFT route keeps in shared memory: channel 1 (for the
// mel product: a multiple of 8 rows, which emit_mel_rows reads; the
// statistics kernel: the tile) and channel 2 (the IF's angles of the halo
// frame and the tile; the statistics kernel: else channel 2 of the tile).
__host__ __device__ inline void repr_fft_rows(int tile_t, int second, bool stats, bool mel, int* c1,
                                              int* c2) {
    if (stats) {
        *c1 = tile_t;
        *c2 = second == kSecondIF ? tile_t + 1 : tile_t;
    } else {
        *c1 = mel && second != kSecondImag ? (tile_t + 7) / 8 * 8 : 0;
        *c2 = second == kSecondIF ? tile_t + 1 : 0;
    }
}

__host__ __device__ inline size_t repr_fft_smem_floats(int tile_t, int hop, int overlap, int F,
                                                       int teams, bool stats, int second, bool mel) {
    int c1, c2;
    repr_fft_rows(tile_t, second, stats, mel, &c1, &c2);
    return (size_t)(tile_t + repr_fft_halo(second) + overlap - 1) * hop + (size_t)(c1 + c2) * F +
           fft_area_floats(overlap * hop, teams);
}

// The unwrapped difference of two consecutive phases is their principal
// difference (unwrap's correction, evaluated frame-locally): |d| < pi as is,
// else ((d + pi) mod 2 pi) - pi, with -pi of a positive d taken as pi.
__device__ __forceinline__ float wrap_diff(float d) {
    if (fabsf(d) < kPi) return d;
    float m = fmodf(d + kPi, kTwoPi);
    if (m != 0.0f && m < 0.0f) m += kTwoPi;
    m -= kPi;
    return (m == -kPi && d > 0.0f) ? kPi : m;
}

// IF row value of global frame f from its phase and the previous frame's:
// frame 0 passes its angle through, the others take half the principal
// difference, every row but the last is divided by pi, and `weighted`
// applies the parabolic window (1.5 T / (T^2 - 1)) (1 - ((f - (T/2 - 1)) /
// (T/2))^2), evaluated in double and rounded once (near its zeros a float
// evaluation cancels, and any two float orders of it differ there).
__device__ __forceinline__ float if_value(float ph, float ph_prev, int f, int T, bool weighted) {
    float v = f == 0 ? ph : wrap_diff(ph - ph_prev) * 0.5f;
    if (f != T - 1) v *= kInvPi;
    if (weighted) {
        const double half = T / 2.0;
        const double u = ((double)f - (half - 1.0)) / half;
        v *= (float)(1.5 * T / ((double)T * T - 1.0) * (1.0 - u * u));
    }
    return v;
}

// Front end of one representation block: its rows into xs, and for each
// column tile `per_tile(k0, useful, n_frames)` with the spectrum in w.  With
// the IF the block computes n_frames = tile_t + 1 frames starting one before
// its tile (row 0 is the halo frame); otherwise its tile_t frames.
template <bool kInt16, int kFront, typename PerTile>
__device__ void repr_front(const ReprArgs& a, long long b, int tile, int halo, float* xs,
                           AnaWork w, PerTile per_tile) {
    const int n_frames = a.tile_t + halo;
    const int n_rows = n_frames + a.overlap - 1;
    load_rows<kInt16>(a.x_rows, (size_t)b * a.n_rows_total + (size_t)tile * a.tile_t + (1 - halo),
                      n_rows, a.hop, xs);
    const int P = a.taps.P;
    const int useful = kColTile - 2 * P;
    const int n_ct = n_col_tiles(a.F, P);
    for (int ct = 0; ct < n_ct; ++ct) {
        if (kFront == kFrontProduct) {
            analysis_tile(xs, n_frames, n_frames, a.hop, a.overlap, a.F, ct, P, a.bcos, a.bsin,
                          a.twr, a.twi, w, a.overlap * a.hop);
        } else {
            analysis_tile(xs, n_rows, n_frames, a.hop, a.overlap, a.F, ct, P, a.bcos, a.bsin,
                          a.twr, a.twi, w);
        }
        per_tile(ct * useful, useful, n_frames);
    }
}

// (re, im) of frame row t, tile column cu + P, bin k: the taps conv, with the
// nyquist bin's imaginary part pinned to 0.
__device__ __forceinline__ void repr_bin(const AnaWork& w, const Taps& taps, int t, int cu, int k,
                                         int F, float* re, float* im) {
    taps_at(w, taps, t, cu + taps.P, re, im);
    if (k == F - 1) *im = 0.0f;
}

__device__ __forceinline__ float repr_angle(float re, float im, int k, int F) {
    // the nyquist bin is exactly real: its angle is 0 or pi.  A zero
    // imaginary part of either sign counts as +0 (the DC bin's is a signed
    // zero whose sign is an accident of the order of additions), so a
    // negative real axis is always +pi, as the TPU kernel's atan2 has it.
    if (k == F - 1) return re < 0.0f ? kPi : 0.0f;
    return atan2f(im == 0.0f ? 0.0f : im, re);
}

// Channel 1 of the FFT route through the mel bank: emit_tile's sums (over
// the bank's nonzero rows [lo, hi) in order, fmaf), contrast and affine, for
// the block's t_valid rows, eight at a time (c1 holds a multiple of 8 rows;
// rows past t_valid are read and never stored).
__device__ void emit_mel_rows(const float* c1, long long b, int t_base, int t_valid, int F, int T,
                              int contrast, const float* __restrict__ mel_bank,
                              const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
                              float offset, float scale, float* __restrict__ out) {
    for (int m = threadIdx.x; m < F; m += kThreads) {
        const int lo = mel_lo[m], hi = mel_hi[m];
        for (int t0 = 0; t0 < t_valid; t0 += 8) {
            float acc[8];
#pragma unroll
            for (int t = 0; t < 8; ++t) acc[t] = 0.0f;
            for (int f = lo; f < hi; ++f) {
                const float bv = __ldg(mel_bank + (size_t)f * F + m);
#pragma unroll
                for (int t = 0; t < 8; ++t) acc[t] = fmaf(c1[(t0 + t) * F + f], bv, acc[t]);
            }
#pragma unroll
            for (int t = 0; t < 8; ++t) {
                if (t0 + t < t_valid) {
                    out[((size_t)b * T + (t_base + t0 + t)) * F + m] =
                        (contrast_of(acc[t], contrast) - offset) / scale;
                }
            }
        }
    }
}

// The FFT route's front end: the window and the twiddles staged, the block's
// rows loaded (frame f of the clip starts at row f + halo: `halo` leading
// zero chunks), then frames_rfft over the halo frames and the tile's first
// t_valid frames, emit(t, k, re, im) with the tile row t (-2 and -1: the
// IF's halo) and the nyquist bin's imaginary part pinned to 0; the FFT's
// area starts at fft_area.  kSmooth: the mixed-radix stages, kSeven: their
// radix-7 stage too.  Ends with a barrier.
template <bool kInt16, bool kSmooth, bool kSeven, typename Emit>
__device__ void repr_fft_front(const ReprArgs& a, long long b, int t_base, int t_valid, float* xs,
                               float* fft_area, Emit emit) {
    const int hf = repr_fft_halo(a.second);
    const int n = a.overlap * a.hop;
    const int n_frames = hf + t_valid;
    const FftSmem fs = carve_fft<kSmooth, kSeven>(fft_area, n);
    fft_stage<kSmooth, kSeven>(a.fft.win, a.fft.tw, fs, n);  // load_rows' barrier covers it
    load_rows<kInt16>(a.x_rows, (size_t)b * a.n_rows_total + (size_t)t_base,
                      n_frames + a.overlap - 1, a.hop, xs);
    const int F = a.F;
    frames_rfft<kSmooth, kSeven>(xs, n_frames, a.hop, n, fs, a.fft.teams, [&](int r, int k, float re, float im) {
        emit(r - hf, k, re, k == F - 1 ? 0.0f : im);
    });
}

// Kernel G on the FFT route, or with kSmooth the smooth one, with kSeven its
// radix-7 instance (see the notes at the top).
template <bool kInt16, bool kSmooth, bool kSeven>
__device__ void repr_forward_fft(const ReprArgs& a, long long b, int tile, float* smem) {
    const int F = a.F, T = a.T, second = a.second;
    const bool mel = a.mel_bank != nullptr && second != kSecondImag;
    int c1r, c2r;
    repr_fft_rows(a.tile_t, second, false, mel, &c1r, &c2r);
    const int t_base = tile * a.tile_t;
    const int t_valid = min(a.tile_t, T - t_base);
    float* xs = smem;
    float* c1_s = xs + (size_t)(a.tile_t + repr_fft_halo(second) + a.overlap - 1) * a.hop;
    float* ph_s = c1_s + (size_t)c1r * F;  // the IF: row t + 1 holds tile row t's angles
    const float off1 = a.aff[0], s1 = a.aff[1], off2 = a.aff[2], s2 = a.aff[3];
    const size_t row0 = (size_t)b * T + t_base;
    repr_fft_front<kInt16, kSmooth, kSeven>(a, b, t_base, t_valid, xs, ph_s + (size_t)c2r * F,
                           [&](int t, int k, float re, float im) {
        if (second == kSecondImag) {
            a.out1[(row0 + t) * F + k] = (re - off1) / s1;
            a.out2[(row0 + t) * F + k] = (im - off2) / s2;
            return;
        }
        if (t < -1) return;  // the halo's partner
        const float ph = repr_angle(re, im, k, F);
        if (second == kSecondIF) ph_s[(t + 1) * F + k] = ph;
        if (t < 0) return;
        const float mg = sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
        if (mel) {
            c1_s[t * F + k] = mg;
        } else {
            a.out1[(row0 + t) * F + k] = (contrast_of(mg, a.contrast) - off1) / s1;
        }
        if (second == kSecondPhase) a.out2[(row0 + t) * F + k] = (ph - off2) / s2;
    });  // ends with a barrier
    if (second == kSecondIF) {
        for (int idx = threadIdx.x; idx < t_valid * F; idx += kThreads) {
            const int t = idx / F;
            const int k = idx - t * F;
            const float v = if_value(ph_s[(t + 1) * F + k], ph_s[t * F + k], t_base + t, T,
                                     a.weighted != 0);
            a.out2[(row0 + t) * F + k] = (v - off2) / s2;
        }
    }
    if (mel) {
        emit_mel_rows(c1_s, b, t_base, t_valid, F, T, a.contrast, a.mel_bank, a.mel_lo, a.mel_hi,
                      off1, s1, a.out1);
    }
}

// Kernel H on the FFT (or, kSmooth, the smooth; kSeven, its radix-7
// instance) route: both channels of the tile in shared memory, then each
// column folded over the frames in frame order (as the product route folds),
// into the block's partials.
template <bool kInt16, bool kSmooth, bool kSeven>
__device__ void repr_stats_fft(const ReprArgs& a, long long blk, long long b, int tile, float* smem) {
    const int F = a.F, T = a.T, second = a.second;
    int c1r, c2r;
    repr_fft_rows(a.tile_t, second, true, false, &c1r, &c2r);
    const int t_base = tile * a.tile_t;
    const int t_valid = min(a.tile_t, T - t_base);  // frames past T are tile padding
    const bool is_if = second == kSecondIF;
    float* xs = smem;
    float* c1_s = xs + (size_t)(a.tile_t + repr_fft_halo(second) + a.overlap - 1) * a.hop;
    float* c2_s = c1_s + (size_t)c1r * F;  // the IF: row t + 1 holds tile row t's angle
    repr_fft_front<kInt16, kSmooth, kSeven>(a, b, t_base, t_valid, xs, c2_s + (size_t)c2r * F,
                           [&](int t, int k, float re, float im) {
        if (second == kSecondImag) {
            c1_s[t * F + k] = re;
            c2_s[t * F + k] = im;
            return;
        }
        if (t < -1) return;  // the halo's partner
        const float ph = repr_angle(re, im, k, F);
        c2_s[(t + (is_if ? 1 : 0)) * F + k] = ph;
        if (t < 0) return;
        c1_s[t * F + k] = contrast_of(sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))),
                                      a.contrast);
    });  // ends with a barrier
    float* dst = a.partials + (size_t)blk * 8 * F;
    for (int c = threadIdx.x; c < 2 * F; c += kThreads) {
        const int ch = c >= F ? 1 : 0;
        const int k = c - ch * F;
        float s = 0.0f, ss = 0.0f, mn = INFINITY, mx = -INFINITY;
        for (int t = 0; t < t_valid; ++t) {
            float v;
            if (ch == 0) {
                v = c1_s[t * F + k];
            } else if (is_if) {
                v = if_value(c2_s[(t + 1) * F + k], c2_s[t * F + k], t_base + t, T, a.weighted != 0);
            } else {
                v = c2_s[t * F + k];
            }
            s += v;
            ss = fmaf(v, v, ss);
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
        }
        float* d = dst + (size_t)ch * 4 * F;
        d[k] = s;
        d[F + k] = ss;
        d[2 * F + k] = mn;
        d[3 * F + k] = mx;
    }
}

// On the FFT and smooth routes (the radix-7 instance too) at most 128
// registers a thread, as melspec_forward_kernel's.
template <bool kInt16, int kFront>
__global__ void __launch_bounds__(kThreads, front_is_fft(kFront) ? 2 : 1)
repr_forward_kernel(ReprArgs a) {
    extern __shared__ __align__(16) float smem[];
    if constexpr (front_is_fft(kFront)) {
        const long long blk = blockIdx.x;
        const long long b = blk / a.n_tiles;
        repr_forward_fft<kInt16, front_is_smooth(kFront), kFront == kFrontSmooth7>(
            a, b, (int)(blk - b * a.n_tiles), smem);
    } else {
        const int halo = a.second == kSecondIF ? 1 : 0;
        const int F = a.F, T = a.T;
        float* xs = smem;
        float* mag_s = xs + (size_t)(a.tile_t + a.overlap) * a.hop;
        AnaWork w = carve_ana(mag_s + (size_t)a.tile_t * F, a.tile_t + 1);
        float* ph_s = w.Cre;  // phases of a column tile, free once X is combined

        const long long blk = blockIdx.x;
        const long long b = blk / a.n_tiles;
        const int tile = (int)(blk - b * a.n_tiles);
        const int t_base = tile * a.tile_t;
        const float off1 = a.aff[0], s1 = a.aff[1], off2 = a.aff[2], s2 = a.aff[3];
        const size_t row_b = (size_t)b * T;

        repr_front<kInt16, kFront>(a, b, tile, halo, xs, w, [&](int k0, int useful, int n_frames) {
            for (int idx = threadIdx.x; idx < n_frames * useful; idx += kThreads) {
                const int t = idx / useful;
                const int cu = idx - t * useful;
                const int k = k0 + cu;
                const int f = t_base + t - halo;  // global frame of row t
                if (k >= F) continue;
                float re, im;
                repr_bin(w, a.taps, t, cu, k, F, &re, &im);
                if (a.second == kSecondImag) {
                    if (f < T) {
                        a.out1[(row_b + f) * F + k] = (re - off1) / s1;
                        a.out2[(row_b + f) * F + k] = (im - off2) / s2;
                    }
                    continue;
                }
                if (t >= halo) mag_s[(t - halo) * F + k] = sqrtf(re * re + im * im);
                const float ph = repr_angle(re, im, k, F);
                if (a.second == kSecondPhase) {
                    if (f < T) a.out2[(row_b + f) * F + k] = (ph - off2) / s2;
                } else {
                    ph_s[t * kColTile + cu] = ph;
                }
            }
            if (a.second != kSecondIF) return;
            __syncthreads();
            for (int idx = threadIdx.x; idx < a.tile_t * useful; idx += kThreads) {
                const int t = idx / useful;  // output row: halo row t + 1
                const int cu = idx - t * useful;
                const int k = k0 + cu;
                const int f = t_base + t;
                if (k >= F || f >= T) continue;
                const float v = if_value(ph_s[(t + 1) * kColTile + cu], ph_s[t * kColTile + cu], f, T,
                                         a.weighted != 0);
                a.out2[(row_b + f) * F + k] = (v - off2) / s2;
            }
            // analysis_tile begins with a barrier before the work area is reused
        });
        if (a.second == kSecondImag) return;
        __syncthreads();
        switch (a.tile_t) {
            case 32:
                emit_tile<32, false>(mag_s, b, t_base, F, T, a.contrast, a.mel_bank, a.mel_lo, a.mel_hi,
                                     F, off1, s1, a.out1);
                break;
            case 16:
                emit_tile<16, false>(mag_s, b, t_base, F, T, a.contrast, a.mel_bank, a.mel_lo, a.mel_hi,
                                     F, off1, s1, a.out1);
                break;
            default:
                emit_tile<8, false>(mag_s, b, t_base, F, T, a.contrast, a.mel_bank, a.mel_lo, a.mel_hi,
                                    F, off1, s1, a.out1);
        }
    }
}

template <bool kInt16, int kFront>
__global__ void __launch_bounds__(kThreads, front_is_fft(kFront) ? 2 : 1)
repr_stats_kernel(ReprArgs a) {
    extern __shared__ __align__(16) float smem[];
    if constexpr (front_is_fft(kFront)) {
        const long long blk = blockIdx.x;
        const long long b = blk / a.n_tiles;
        repr_stats_fft<kInt16, front_is_smooth(kFront), kFront == kFrontSmooth7>(
            a, blk, b, (int)(blk - b * a.n_tiles), smem);
    } else {
        const int halo = a.second == kSecondIF ? 1 : 0;
        const int F = a.F, T = a.T;
        float* xs = smem;
        AnaWork w = carve_ana(xs + (size_t)(a.tile_t + a.overlap) * a.hop, a.tile_t + 1);
        // per column tile, rows as the frame rows: ch1 in Cim; ch2 in Cre (the
        // phase, or Im), for the IF in Xre once X has been read
        float* c1_s = w.Cim;
        float* ph_s = w.Cre;

        const long long blk = blockIdx.x;
        const long long b = blk / a.n_tiles;
        const int tile = (int)(blk - b * a.n_tiles);
        const int t_base = tile * a.tile_t;
        const int t_valid = min(a.tile_t, T - t_base);  // frames past T are tile padding
        float* dst = a.partials + (size_t)blk * 8 * F;

        repr_front<kInt16, kFront>(a, b, tile, halo, xs, w, [&](int k0, int useful, int n_frames) {
            for (int idx = threadIdx.x; idx < n_frames * useful; idx += kThreads) {
                const int t = idx / useful;
                const int cu = idx - t * useful;
                const int k = k0 + cu;
                if (k >= F) continue;
                float re, im;
                repr_bin(w, a.taps, t, cu, k, F, &re, &im);
                if (a.second == kSecondImag) {
                    c1_s[t * kColTile + cu] = re;
                    ph_s[t * kColTile + cu] = im;
                } else {
                    c1_s[t * kColTile + cu] = contrast_of(sqrtf(re * re + im * im), a.contrast);
                    ph_s[t * kColTile + cu] = repr_angle(re, im, k, F);
                }
            }
            __syncthreads();
            float* c2_s = ph_s;
            if (a.second == kSecondIF) {
                c2_s = w.Xre;
                for (int idx = threadIdx.x; idx < t_valid * useful; idx += kThreads) {
                    const int t = idx / useful;
                    const int cu = idx - t * useful;
                    c2_s[(t + 1) * kColTile + cu] =
                        if_value(ph_s[(t + 1) * kColTile + cu], ph_s[t * kColTile + cu], t_base + t, T,
                                 a.weighted != 0);
                }
                __syncthreads();
            }
            // threads 0..127 fold channel 1 of a column, 128..255 channel 2
            const int c = threadIdx.x & (kColTile - 1);
            const int ch = threadIdx.x / kColTile;
            const int k = k0 + c;
            if (c < useful && k < F) {
                const float* col = (ch == 0 ? c1_s : c2_s) + halo * kColTile + c;
                float s = 0.0f, ss = 0.0f, mn = INFINITY, mx = -INFINITY;
                for (int t = 0; t < t_valid; ++t) {
                    const float v = col[t * kColTile];
                    s += v;
                    ss = fmaf(v, v, ss);
                    mn = fminf(mn, v);
                    mx = fmaxf(mx, v);
                }
                float* d = dst + (size_t)ch * 4 * F;
                d[k] = s;
                d[F + k] = ss;
                d[2 * F + k] = mn;
                d[3 * F + k] = mx;
            }
        });
    }
}

// partials (n_blocks, n_stats, F) float -> stats (n_stats, F) double, in a
// fixed order: statistic `stat` folds as sum, sum, min, max by stat % 4.  A
// block owns 32 bins of one statistic, its 8 warps each fold every 8th
// partial, and warp 0 folds the 8 results in order.
__global__ void __launch_bounds__(kThreads)
stats_reduce_kernel(const float* __restrict__ partials, long long n_blocks, int F, int n_stats,
                    double* __restrict__ stats) {
    __shared__ double sh[8][32];
    const int lane = threadIdx.x & 31;
    const int slice = threadIdx.x >> 5;
    const int k = blockIdx.x * 32 + lane;
    const int stat = blockIdx.y;
    const int kind = stat % 4;
    const double init = kind == 2 ? (double)INFINITY : (kind == 3 ? -(double)INFINITY : 0.0);
    auto fold = [kind](double acc, double v) {
        return kind < 2 ? acc + v : (kind == 2 ? fmin(acc, v) : fmax(acc, v));
    };
    double acc = init;
    if (k < F) {
#pragma unroll 4
        for (long long blk = slice; blk < n_blocks; blk += 8) {
            acc = fold(acc, (double)partials[((size_t)blk * n_stats + stat) * F + k]);
        }
    }
    sh[slice][lane] = acc;
    __syncthreads();
    if (slice == 0 && k < F) {
        double r = init;
        for (int s = 0; s < 8; ++s) r = fold(r, sh[s][lane]);
        stats[(size_t)stat * F + k] = r;
    }
}

static size_t forward_smem_bytes(int tile_t, int hop, int overlap, int F) {
    size_t floats = (size_t)(tile_t + overlap - 1) * hop + (size_t)tile_t * F +
                    ana_work_floats();
    return floats * sizeof(float);
}

// The FFT and smooth routes: the same rows and magnitudes, then
// frames_rfft's area on the route n_fft takes.
static size_t forward_fft_smem_bytes(int tile_t, int hop, int overlap, int F, int teams) {
    size_t floats = (size_t)(tile_t + overlap - 1) * hop + (size_t)tile_t * F +
                    fft_area_floats(overlap * hop, teams);
    return floats * sizeof(float);
}

// The shared arguments of att_melspec_forward and att_melspec_stats: whether
// they hold, and the route's shared memory.  fft_teams > 0 takes the FFT
// route where fft_covers(n_fft), the smooth route where fft_covers_smooth7
// (its radix-7 instance where n_fft has a factor 7).
static bool melspec_args_ok(int P, int overlap, int tile_t, int hop, int F, int fft_teams) {
    const int n = overlap * hop;
    return P < kMaxTaps && overlap >= 1 && tile_t + overlap - 1 <= kMaxRows &&
           (tile_t == 32 || tile_t == 16 || tile_t == 8) && hop % kKC == 0 &&
           (fft_teams == 0 ||
            (P < 0 && F == n / 2 + 1 &&
             ((fft_covers(n) && fft_teams <= fft_max_teams(n)) ||
              (fft_covers_smooth7(n) && fft_teams <= fft_smooth_max_teams(n)))));
}

// The front end of a launch: P >= 0 the factored one; full-K, fft_teams > 0
// the FFT route where fft_covers(n_fft), else the smooth one (its radix-7
// instance where n_fft has a factor 7); else the product.
static int melspec_front(int P, int n_fft, int fft_teams) {
    if (P >= 0) return kFrontFactored;
    if (fft_teams == 0) return kFrontProduct;
    if (fft_covers(n_fft)) return kFrontFft;
    return n_fft % 7 == 0 ? kFrontSmooth7 : kFrontSmooth;
}

static size_t melspec_smem_bytes(int tile_t, int hop, int overlap, int F, int fft_teams) {
    return fft_teams > 0 ? forward_fft_smem_bytes(tile_t, hop, overlap, F, fft_teams)
                         : forward_smem_bytes(tile_t, hop, overlap, F);
}

// The representation kernels hold one chunk (the halo frame's) and one
// spectrum row more; the statistics kernel has no channel-1 rows.
static size_t repr_smem_bytes(int tile_t, int hop, int overlap, int F, bool stats) {
    size_t floats = (size_t)(tile_t + overlap) * hop + (stats ? 0 : (size_t)tile_t * F) +
                    ana_work_floats(tile_t + 1);
    return floats * sizeof(float);
}

static Taps make_taps(const float* c, int P) {
    Taps t;
    for (int i = 0; i < kMaxTaps; ++i) t.c[i] = i <= P ? c[i] : 0.0f;
    t.P = P;
    return t;
}

// The full-K front end applies the window in its basis: the taps conv is the identity.
static Taps unit_taps() {
    Taps t;
    for (int i = 0; i < kMaxTaps; ++i) t.c[i] = i == 0 ? 1.0f : 0.0f;
    t.P = 0;
    return t;
}

template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace att

extern "C" {

// Shared memory one block of the forward / statistics kernel needs.
long long att_melspec_smem_bytes(int tile_t, int hop, int overlap, int F) {
    return (long long)att::forward_smem_bytes(tile_t, hop, overlap, F);
}

// The same for the FFT route (n_fft a power of two) or the smooth route
// (n_fft even, 7-smooth, no power of two) with `teams` FFTs side by side.
long long att_melspec_fft_smem_bytes(int tile_t, int hop, int overlap, int F, int teams) {
    return (long long)att::forward_fft_smem_bytes(tile_t, hop, overlap, F, teams);
}

const char* att_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x_rows: (B, n_rows_total, hop) float32 or int16, n_rows_total >= n_tiles * tile_t +
// overlap - 1, tile_t one of 32, 16, 8.  out: (B, T, M or F) float32 or bfloat16.
// P >= 0: bcos / bsin are the (hop, F) chunk basis, twr / twi the twiddles.
// P < 0 selects a full-K front end, twr / twi and taps_host not read: with
// fft_teams > 0 the FFT route (n_fft = overlap hop a power of two from 64 to
// 4096, fft_teams <= 4096 / n_fft FFTs side by side) or the smooth route
// (n_fft even, 2^a 3^b 5^c 7^d, 64 to 4096 and no power of two, fft_teams <=
// fft_smooth_max_teams(n_fft); the radix-7 instance where n_fft has a
// factor 7); window (n_fft,), fft_tw (2, n_fft) = (cos,
// -sin)(2 pi j / n_fft); bcos / bsin not read; with fft_teams == 0 the
// product route (bcos / bsin the window-folded (n_fft, F) basis; window /
// fft_tw not read).  Returns a cudaError_t.
int att_melspec_forward(const void* x_rows, int x_int16, long long B, int n_tiles, int tile_t,
                        int n_rows_total, int hop, int overlap, int F, int T,
                        const float* bcos, const float* bsin, const float* twr,
                        const float* twi, const float* taps_host, int P, int power2,
                        int contrast, const float* mel_bank, const int* mel_lo,
                        const int* mel_hi, int M, const float* aff, void* out, int out_bf16,
                        const float* window, const float* fft_tw, int fft_teams, void* stream) {
    using namespace att;
    if (!melspec_args_ok(P, overlap, tile_t, hop, F, fft_teams)) return (int)cudaErrorInvalidValue;
    const int front = melspec_front(P, overlap * hop, fft_teams);
    const size_t smem = melspec_smem_bytes(tile_t, hop, overlap, F, fft_teams);
    Taps taps = P < 0 ? unit_taps() : make_taps(taps_host, P);
    const FftArgs fft = {window, fft_tw, fft_teams};
    dim3 grid((unsigned)(B * n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_FWD(I16, BF, FR)                                                        \
    do {                                                                                   \
        err = allow_smem(melspec_forward_kernel<I16, BF, FR>, smem);                       \
        if (err != cudaSuccess) return (int)err;                                           \
        melspec_forward_kernel<I16, BF, FR><<<grid, kThreads, smem, s>>>(                  \
            x_rows, n_tiles, tile_t, n_rows_total, hop, overlap, F, T, bcos, bsin, twr,    \
            twi, taps, power2, contrast, mel_bank, mel_lo, mel_hi, M, aff, out, fft);      \
    } while (0)
#define ATT_LAUNCH_FWD_FR(I16, BF)                                                         \
    do {                                                                                   \
        if (front == kFrontFft) ATT_LAUNCH_FWD(I16, BF, kFrontFft);                        \
        else if (front == kFrontSmooth) ATT_LAUNCH_FWD(I16, BF, kFrontSmooth);             \
        else if (front == kFrontSmooth7) ATT_LAUNCH_FWD(I16, BF, kFrontSmooth7);           \
        else if (front == kFrontProduct) ATT_LAUNCH_FWD(I16, BF, kFrontProduct);           \
        else ATT_LAUNCH_FWD(I16, BF, kFrontFactored);                                      \
    } while (0)
    if (x_int16) {
        if (out_bf16) ATT_LAUNCH_FWD_FR(true, true); else ATT_LAUNCH_FWD_FR(true, false);
    } else {
        if (out_bf16) ATT_LAUNCH_FWD_FR(false, true); else ATT_LAUNCH_FWD_FR(false, false);
    }
#undef ATT_LAUNCH_FWD_FR
#undef ATT_LAUNCH_FWD
    return (int)cudaGetLastError();
}

// Kernel T: A cut after stage `stage` (0, 1, 3-8: csrc/spectral.cu's
// kStage*), on float32 rows laid out as for att_melspec_forward with P >= 0,
// A's grid, threads and shared memory whatever the stage needs, and A's
// configuration: magnitudes from stage 5 on, log1p at stage 7.  out: (B, T,
// F) float32 up to stage 5, (B, T, M) from stage 6 on; mel_bank / mel_lo /
// mel_hi as for att_melspec_forward.  Returns a cudaError_t.
int att_melspec_stage(int stage, const float* x_rows, long long B, int n_tiles, int tile_t,
                      int n_rows_total, int hop, int overlap, int F, int T, const float* bcos,
                      const float* bsin, const float* twr, const float* twi,
                      const float* taps_host, int P, const float* mel_bank, const int* mel_lo,
                      const int* mel_hi, int M, const float* aff, float* out, void* stream) {
    using namespace att;
    if (P < 0 || P >= kMaxTaps || overlap < 1 || tile_t + overlap - 1 > kMaxRows ||
        (tile_t != 32 && tile_t != 16 && tile_t != 8) || hop % kKC != 0 ||
        (stage >= kStageMel && mel_bank == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = forward_smem_bytes(tile_t, hop, overlap, F);
    const Taps taps = make_taps(taps_host, P);
    const dim3 grid((unsigned)(B * n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_STAGE(S)                                                                \
    case S:                                                                                \
        err = allow_smem(melspec_stage_kernel<S>, smem);                                   \
        if (err != cudaSuccess) return (int)err;                                           \
        melspec_stage_kernel<S><<<grid, kThreads, smem, s>>>(                              \
            x_rows, n_tiles, tile_t, n_rows_total, hop, overlap, F, T, bcos, bsin, twr,    \
            twi, taps, 0, 1, mel_bank, mel_lo, mel_hi, M, aff, out);                       \
        break
    switch (stage) {
        ATT_LAUNCH_STAGE(kStageCopy);
        ATT_LAUNCH_STAGE(kStageDots);
        ATT_LAUNCH_STAGE(kStageCombine);
        ATT_LAUNCH_STAGE(kStageTaps);
        ATT_LAUNCH_STAGE(kStageMag);
        ATT_LAUNCH_STAGE(kStageMel);
        ATT_LAUNCH_STAGE(kStageFull);
        ATT_LAUNCH_STAGE(kStageMelDense);
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef ATT_LAUNCH_STAGE
    return (int)cudaGetLastError();
}

// partials: (B * n_tiles, 4, F) float32 scratch; stats: (4, F) float64 out
// (rows: sum, sumsq, min, max per bin).  P < 0: a full-K front end, and
// fft_teams selects its route (FFT, smooth, the smooth route's radix-7
// instance, or product), as in att_melspec_forward.  Returns a cudaError_t.
int att_melspec_stats(const void* x_rows, int x_int16, long long B, int n_tiles, int tile_t,
                      int n_rows_total, int hop, int overlap, int F, int T, const float* bcos,
                      const float* bsin, const float* twr, const float* twi,
                      const float* taps_host, int P, int contrast, float* partials,
                      double* stats, const float* window, const float* fft_tw, int fft_teams,
                      void* stream) {
    using namespace att;
    if (!melspec_args_ok(P, overlap, tile_t, hop, F, fft_teams)) return (int)cudaErrorInvalidValue;
    const int front = melspec_front(P, overlap * hop, fft_teams);
    const size_t smem = melspec_smem_bytes(tile_t, hop, overlap, F, fft_teams);
    Taps taps = P < 0 ? unit_taps() : make_taps(taps_host, P);
    const FftArgs fft = {window, fft_tw, fft_teams};
    dim3 grid((unsigned)(B * n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_STATS(I16, FR)                                                          \
    do {                                                                                   \
        err = allow_smem(melspec_stats_kernel<I16, FR>, smem);                             \
        if (err != cudaSuccess) return (int)err;                                           \
        melspec_stats_kernel<I16, FR><<<grid, kThreads, smem, s>>>(                        \
            x_rows, n_tiles, tile_t, n_rows_total, hop, overlap, F, T, bcos, bsin, twr,    \
            twi, taps, contrast, partials, fft);                                           \
    } while (0)
#define ATT_LAUNCH_STATS_FR(I16)                                                           \
    do {                                                                                   \
        if (front == kFrontFft) ATT_LAUNCH_STATS(I16, kFrontFft);                          \
        else if (front == kFrontSmooth) ATT_LAUNCH_STATS(I16, kFrontSmooth);               \
        else if (front == kFrontSmooth7) ATT_LAUNCH_STATS(I16, kFrontSmooth7);             \
        else if (front == kFrontProduct) ATT_LAUNCH_STATS(I16, kFrontProduct);             \
        else ATT_LAUNCH_STATS(I16, kFrontFactored);                                        \
    } while (0)
    if (x_int16) {
        ATT_LAUNCH_STATS_FR(true);
    } else {
        ATT_LAUNCH_STATS_FR(false);
    }
#undef ATT_LAUNCH_STATS_FR
#undef ATT_LAUNCH_STATS
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    stats_reduce_kernel<<<dim3((F + 31) / 32, 4), kThreads, 0, s>>>(partials, B * n_tiles, F, 4,
                                                                     stats);
    return (int)cudaGetLastError();
}

long long att_repr_smem_bytes(int tile_t, int hop, int overlap, int F, int stats) {
    return (long long)att::repr_smem_bytes(tile_t, hop, overlap, F, stats != 0);
}

// The same for the FFT route (n_fft a power of two) or the smooth route
// (n_fft even, 7-smooth, no power of two) with `teams` FFTs side by side,
// channel-2 selector `second` and a mel bank or not.
long long att_repr_fft_smem_bytes(int tile_t, int hop, int overlap, int F, int teams, int stats,
                                  int second, int mel) {
    return (long long)(att::repr_fft_smem_floats(tile_t, hop, overlap, F, teams, stats != 0, second,
                                                 mel != 0) *
                       sizeof(float));
}

// Kernels G (stats = 0) and H (stats = 1).  x_rows: (B, n_rows_total, hop)
// float32 or int16.  P >= 0: factored front end (chunk basis, twiddles,
// taps); P < 0: full-K, and fft_teams selects its route.  fft_teams == 0: the
// product route (bcos / bsin the window-folded (n_fft, F) basis).  On these
// two x_rows has one leading zero chunk, n_rows_total >= n_tiles * tile_t +
// overlap, tile_t one of 32, 16, 8, hop a multiple of 32.  fft_teams > 0: the
// FFT route (n_fft = overlap hop a power of two from 64 to 4096, fft_teams <=
// 4096 / n_fft FFTs side by side) or the smooth route (n_fft even, 2^a 3^b
// 5^c 7^d, 64 to 4096 and no power of two, fft_teams <=
// fft_smooth_max_teams(n_fft); the radix-7 instance where n_fft has a factor
// 7), F = n_fft / 2 + 1; window (n_fft,), fft_tw (2, n_fft) = (cos, -sin)(2 pi j
// / n_fft); bcos / bsin / twr / twi not read; x_rows has 2 leading zero chunks with the IF (second = 1), none
// otherwise, n_rows_total >= n_tiles * tile_t + that + overlap - 1; tile_t
// one of 32, 16, 8, 4, 2.  second: 0 phase, 1 IF, 2 imag.  G: aff = [off1,
// scale1, off2, scale2] on the device, out1 / out2: (B, T, F) float32;
// mel_bank (F, F) or null.  H: partials (B * n_tiles, 8, F) float32 scratch,
// stats (8, F) float64 out (rows: sum, sumsq, min, max of channel 1, then of
// channel 2).  Returns a cudaError_t.
int att_repr(int stats_mode, const void* x_rows, int x_int16, long long B, int n_tiles, int tile_t,
             int n_rows_total, int hop, int overlap, int F, int T, const float* bcos,
             const float* bsin, const float* twr, const float* twi, const float* taps_host, int P,
             int second, int weighted, int contrast, const float* mel_bank, const int* mel_lo,
             const int* mel_hi, const float* aff, float* out1, float* out2, float* partials,
             double* stats, const float* window, const float* fft_tw, int fft_teams,
             void* stream) {
    using namespace att;
    const bool fullk = P < 0;
    const bool fft = fft_teams > 0;
    const int n_fft = overlap * hop;
    if (P >= kMaxTaps || overlap < 1 || second < 0 || second > 2 ||
        (fft && (!fullk || F != n_fft / 2 + 1 ||
                 !((fft_covers(n_fft) && fft_teams <= fft_max_teams(n_fft)) ||
                   (fft_covers_smooth7(n_fft) && fft_teams <= fft_smooth_max_teams(n_fft))) ||
                 (tile_t != 32 && tile_t != 16 && tile_t != 8 && tile_t != 4 && tile_t != 2))) ||
        (!fft && (tile_t + overlap > kMaxRows || (tile_t != 32 && tile_t != 16 && tile_t != 8) ||
                  hop % kKC != 0))) {
        return (int)cudaErrorInvalidValue;
    }
    ReprArgs a;
    a.x_rows = x_rows;
    a.n_tiles = n_tiles; a.tile_t = tile_t; a.n_rows_total = n_rows_total; a.hop = hop;
    a.overlap = overlap; a.F = F; a.T = T;
    a.bcos = bcos; a.bsin = bsin; a.twr = twr; a.twi = twi;
    a.taps = fullk ? unit_taps() : make_taps(taps_host, P);
    a.second = second; a.weighted = weighted; a.contrast = contrast;
    a.mel_bank = mel_bank; a.mel_lo = mel_lo; a.mel_hi = mel_hi; a.aff = aff;
    a.out1 = out1; a.out2 = out2; a.partials = partials;
    a.fft = FftArgs{window, fft_tw, fft_teams};
    const size_t smem = fft ? repr_fft_smem_floats(tile_t, hop, overlap, F, fft_teams, stats_mode != 0,
                                                   second, mel_bank != nullptr) * sizeof(float)
                            : repr_smem_bytes(tile_t, hop, overlap, F, stats_mode != 0);
    dim3 grid((unsigned)(B * n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_REPR(KERNEL, I16, FK)                                                   \
    do {                                                                                   \
        err = allow_smem(KERNEL<I16, FK>, smem);                                           \
        if (err != cudaSuccess) return (int)err;                                           \
        KERNEL<I16, FK><<<grid, kThreads, smem, s>>>(a);                                   \
    } while (0)
#define ATT_LAUNCH_REPR_FR(KERNEL, I16)                                                    \
    do {                                                                                   \
        if (fft && fft_covers(n_fft)) ATT_LAUNCH_REPR(KERNEL, I16, kFrontFft);             \
        else if (fft && n_fft % 7 == 0) ATT_LAUNCH_REPR(KERNEL, I16, kFrontSmooth7);       \
        else if (fft) ATT_LAUNCH_REPR(KERNEL, I16, kFrontSmooth);                          \
        else if (fullk) ATT_LAUNCH_REPR(KERNEL, I16, kFrontProduct);                       \
        else ATT_LAUNCH_REPR(KERNEL, I16, kFrontFactored);                                 \
    } while (0)
#define ATT_LAUNCH_REPR_ALL(KERNEL)                                                        \
    do {                                                                                   \
        if (x_int16) ATT_LAUNCH_REPR_FR(KERNEL, true);                                     \
        else ATT_LAUNCH_REPR_FR(KERNEL, false);                                            \
    } while (0)
    if (stats_mode) {
        ATT_LAUNCH_REPR_ALL(repr_stats_kernel);
    } else {
        ATT_LAUNCH_REPR_ALL(repr_forward_kernel);
    }
#undef ATT_LAUNCH_REPR_ALL
#undef ATT_LAUNCH_REPR_FR
#undef ATT_LAUNCH_REPR
    err = cudaGetLastError();
    if (err != cudaSuccess || !stats_mode) return (int)err;
    stats_reduce_kernel<<<dim3((F + 31) / 32, 8), kThreads, 0, s>>>(partials, B * n_tiles, F, 8,
                                                                     stats);
    return (int)cudaGetLastError();
}

}  // extern "C"
