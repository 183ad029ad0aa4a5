// Phase Gradient Heap Integration, peak-anchored scan form, and the windowed
// inverse DFT with overlap-add, for Hopper (sm_90a).
//
// Replaces, from the JAX package's ops/pallas/pghi_kernel.py:
//   pghi_phases_kernel      <- _pghi_invert_kernel, recurrence part (emit_phases, bidir)
//   pghi_synthesize_fft_kernel, pghi_synthesize_kernel
//                           <- _pghi_invert_kernel, synthesis part (phases_in), with
//                              ops/pallas/ola.py:ola_accumulate: the FFT route
//                              (fft_smem.cuh:frames_irfft) where n_fft is a power of
//                              two from 64 to 4096, the product route elsewhere
// pghi_invert_fused is the first followed by the second.  And from
// ops/pallas/stream_step.py:
//   rt_pghi_phases_kernel   <- _rt_pghi_phases, the recurrence of the streaming
//                              sessions _session_pghi_kernel (N),
//                              _session_pghi_invert_kernel (Q) and the seed of
//                              _session_pghi_gl_kernel (O); their analysis and
//                              synthesis are kernels of stream_step.cu
//
// What bounds them on this card.  The recurrence is bound by latency, not by
// bytes or operations: per frame a clip does a few operations on F values, but
// frame t needs frame t - 1, so a clip is one chain of T dependent steps.  The
// function as a whole (magnitudes and angles read once, audio written once,
// against an inverse FFT's operations) is bound by bytes.  The synthesis on
// the FFT route does an inverse FFT's operations a frame; on the product
// route it keeps the product form of the kernel it replaces, 2F * n_fft
// multiply-adds per frame (1.05 M at n_fft 1024, 41 times the FFT's), so that
// route's own ceiling is the card's fp32 FMA rate.
//
// Design.  Two kernels, because the two halves want opposite shapes: the
// recurrence is serial in time and independent across clips, so one thread
// block walks one clip (one chain of a clip for `bidir`), all of them in
// flight at once; the synthesis has no dependency and is cut into clip x
// frame-tile blocks that fill the card.  The phases go through device memory
// in between (one array of the spectrogram's size, written and read once).
//
// Recurrence: a thread owns kBPT adjacent bins and keeps their phase carry in
// registers.  Per step it reads the previous, current and next frame's
// magnitude, takes the logarithms, the gradients, the anchor mask and, for a
// frame without an anchor, the frame maximum; then the fill runs as two
// segmented scans of affine maps x -> a x + b (a = 0 at anchors resets the
// chain; a second channel counts the distance to the anchor), one upward and
// one downward: head-flagged Kogge-Stone by warp shuffles inside a warp, the
// warps' totals through shared memory, again by shuffles.  The form is kept
// because a prefix sum of the steps minus its value at the nearest anchor
// cancels two numbers of size pi * F.  Phases are not wrapped (that would be
// another result), so every addition on them is written with __fadd_rn and
// friends: the compiler may not contract or reorder them, and the plain
// PyTorch version repeats them in the same order.  logf / sincosf are the
// full-range functions; this file must not be built with --use_fast_math.
//
// bidir: chain 0 walks frames mid .. T - 1, chain 1 walks mid - 1 .. 0 with
// the sign of the time trapezoid and of the time derivative flipped.  Chain 1
// first repeats chain 0's seed step (frame mid with its true neighbours), so
// its carry is the seed phase without any exchange between blocks.
//
// Streaming (RT-PGHI, rt_pghi_phases_kernel): the same fill per frame with
// the causal time stencil (3 Y[t] - 4 Y[t-1] + Y[t-2]) / 2 and, per chunk of
// T_c frames, the chunk's own threshold tol * max over its (T_c, F)
// magnitudes; the phase carry is re-wrapped at each chunk boundary as
// atan2(m sin phi, m cos phi) of the last frame, which is what the chunked
// loop carries (angle of the committed spectrum): the phases then stay within
// one chunk's growth (16 frames x 2 pi hop k / n_fft) instead of growing over
// the whole session.  Seeded, the kernel starts from a carried history
// instead of two zero frames: the pghi_gl sessions (stream_step.cu) run it
// one chunk at a time, since each chunk's seed starts from the previous
// chunk's polished phases.
//
// Almost nothing in a frame's fill needs the previous frame's phases: the
// threshold, the logarithms, the gradients, the anchors and the onset rule,
// the distances to the nearest anchor on each side and the tie rule, and the
// segment sums of the frequency steps from an anchor come from magnitudes
// alone.  So the fill is split, and one block walks one session with two
// kinds of warps.  Producer warps plan a stage of frames (up to 16, within a
// chunk) at a time, all together: the next chunk's threshold a stage ahead
// (which also brings it into L2), the stage's angles by cp.async into a
// stage buffer, the logarithms and the bins' flags, ct and the frequency
// derivatives, each lanes on consecutive bins; then a frame a warp
// (rt_plan_frame) two segmented scans over 128-bin tiles (4 bins a lane,
// Kogge-Stone over the lanes, the tiles' carry; a head restarts the sum)
// give every bin its source (itself at an anchor, the nearest anchor below
// or above, or none) and the segment sum from it (or the constant: 0 in a
// frame without an anchor, the angle of a silent bin).  The chain warps walk
// the frames: phi_t[k] = (phi_{t-1}[src] + ct[src]) + seg[k], one gather
// from a shared-memory phase row, two adds and a store, and one barrier of
// the chain's warps a frame; they read nothing from device memory.  Two
// stage buffers (they fit with one frame up to 4096 bins) let the producers
// plan stage s + 1 while the chain walks stage s.  Measured on the
// card at 64 sessions x 688 frames x 513 bins (chip_smoke.py phase 5): the
// chain is hidden behind the producers, which bound the kernel; one buffer
// (no overlap) and stages of 8 are slower, and a seeded 22-frame chunk is
// faster as two stages of 11 than as one of 22 (PERF.md section 6).  The
// segment sums are local (no cancellation between numbers of the phases'
// size), added to the anchor's phi + ct once; the plain version
// (ops/cuda/stream_step.py: rt_fill_plan, rt_pghi_phases_reference) repeats
// the order of every float32 operation.
//
// Synthesis, FFT route (pghi_synthesize_fft_kernel): a block owns R output
// chunks of one clip (R a multiple of 2 overlap) and runs fft_smem.cuh:
// frames_irfft over the frames behind them, each spectrum bin loaded as
// (__fmul_rn(m, cos phi), __fmul_rn(m, sin phi)) with one sincosf (the
// full-range reduction: unwrapped phases reach 1e5 rad), the synthesis
// window / n_fft folded into wsyn, the overlap-add by classes into a shared
// sample buffer with no atomics.  Frames pair as (f, f + overlap) for f mod 2
// overlap < overlap over the whole clip, and a block synthesizes the partner
// of a halo frame even where it drops the partner's samples, so that no
// sample's rounding depends on the block that computed it: the plain version
// (ops/cuda/pghi_kernel.py:pghi_synthesize_fused_reference) runs
// frames_irfft_reference and overlap_add_classes over the whole clip and
// repeats it.  No basis.
//
// Synthesis, product route (pghi_synthesize_kernel, every other n_fft): see
// synth_ola.cuh.  A block computes mag * (cos, sin)(phase) of its R + overlap
// - 1 frames once into shared memory (sincosf of arguments up to 1e6 takes
// the slow range reduction, so it is not repeated per column pass) and runs
// the product over them.
#include <math.h>

#include "fft_smem.cuh"
#include "synth_ola.cuh"

namespace att {

constexpr float kPghiEps = 1.19e-7f;
constexpr float kPiF = 3.14159265358979323846f;

struct Affine {
    float a, b, d;
};

// Apply `l` (earlier) then `r`.  a is 0 or 1, so the products are exact and
// each channel costs one rounding.
__device__ __forceinline__ Affine compose(const Affine& l, const Affine& r) {
    Affine o;
    o.a = __fmul_rn(l.a, r.a);
    o.b = __fadd_rn(__fmul_rn(l.b, r.a), r.b);
    o.d = __fadd_rn(__fmul_rn(l.d, r.a), r.d);
    return o;
}

__device__ __forceinline__ Affine identity_map() {
    Affine o;
    o.a = 1.0f;
    o.b = 0.0f;
    o.d = 0.0f;
    return o;
}

// Value of lane `lane - delta` (kUp) or `lane + delta` (down), identity outside the warp.
template <bool kUp>
__device__ __forceinline__ Affine shift_lanes(const Affine& x, int delta, int lane) {
    Affine o;
    if (kUp) {
        o.a = __shfl_up_sync(0xffffffffu, x.a, delta);
        o.b = __shfl_up_sync(0xffffffffu, x.b, delta);
        o.d = __shfl_up_sync(0xffffffffu, x.d, delta);
        if (lane < delta) o = identity_map();
    } else {
        o.a = __shfl_down_sync(0xffffffffu, x.a, delta);
        o.b = __shfl_down_sync(0xffffffffu, x.b, delta);
        o.d = __shfl_down_sync(0xffffffffu, x.d, delta);
        if (lane + delta > 31) o = identity_map();
    }
    return o;
}

// Inclusive Kogge-Stone over the lanes of a warp, towards higher (kUp) or lower lanes.
template <bool kUp>
__device__ __forceinline__ Affine warp_scan(Affine x, int lane) {
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        Affine p = shift_lanes<kUp>(x, s, lane);
        x = compose(p, x);
    }
    return x;
}

// Block-wide inclusive segmented scan of e[0..kBPT) per thread, in bin order
// (kUp) or against it.  Order of the compositions, which the plain version
// repeats: inside the thread, then over the lanes' totals, then over the
// warps' totals; the result is compose(compose(warps before, lanes before),
// own prefix).  `totals` holds 32 Affine values of shared memory; the call
// contains one __syncthreads().
template <int kBPT, bool kUp>
__device__ __forceinline__ void block_scan(Affine (&e)[kBPT], Affine* totals, int lane, int warp,
                                           int n_warps) {
    if (kUp) {
#pragma unroll
        for (int j = 1; j < kBPT; ++j) e[j] = compose(e[j - 1], e[j]);
    } else {
#pragma unroll
        for (int j = kBPT - 2; j >= 0; --j) e[j] = compose(e[j + 1], e[j]);
    }
    const Affine incl = warp_scan<kUp>(kUp ? e[kBPT - 1] : e[0], lane);
    if (lane == (kUp ? 31 : 0)) totals[warp] = incl;
    __syncthreads();
    // every warp scans the totals itself: lane l holds the l-th warp in scan order
    const int src = kUp ? lane : n_warps - 1 - lane;
    Affine wt = (lane < n_warps) ? totals[src] : identity_map();
    wt = warp_scan<true>(wt, lane);
    const int pos = kUp ? warp : n_warps - 1 - warp;  // this warp's place in scan order
    Affine wprev;
    wprev.a = __shfl_sync(0xffffffffu, wt.a, pos > 0 ? pos - 1 : 0);
    wprev.b = __shfl_sync(0xffffffffu, wt.b, pos > 0 ? pos - 1 : 0);
    wprev.d = __shfl_sync(0xffffffffu, wt.d, pos > 0 ? pos - 1 : 0);
    if (pos == 0) wprev = identity_map();
    const Affine lprev = shift_lanes<kUp>(incl, 1, lane);
    const Affine before = compose(wprev, lprev);
#pragma unroll
    for (int j = 0; j < kBPT; ++j) e[j] = compose(before, e[j]);
}

struct PghiArgs {
    const float* mag;     // (B, T, F)
    const float* angles;  // (B, T, F) phases of the silent bins
    const float* abstol;  // (B,)
    float* phases;        // (B, T, F) out
    int T, F, bidir;
    float fmul;     // gamma / (hop n_fft)
    float inv_fmul; // 1 / fmul: the time step multiplies by it
    float carrier;  // 2 pi hop / n_fft
};

// Shared memory: 4 rows of n_pad floats (log-magnitude of the previous and
// the current frame, the current magnitude, the frequency step), then the
// warps' maxima (32 floats) and the scans' totals (2 x 32 Affine).
__host__ __device__ inline size_t pghi_phases_smem_bytes(int n_pad) {
    return sizeof(float) * (4 * (size_t)n_pad + 32) + 2 * 32 * sizeof(Affine);
}

template <int kBPT>
__global__ void __launch_bounds__(1024) pghi_phases_kernel(PghiArgs p) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = blockDim.x >> 5;
    const int n_pad = blockDim.x * kBPT;
    const int T = p.T, F = p.F;

    float* sYp = smem;
    float* sYc = sYp + n_pad;
    float* sM = sYc + n_pad;
    float* sFs = sM + n_pad;
    float* sWmax = sFs + n_pad;
    Affine* tot_up = reinterpret_cast<Affine*>(sWmax + 32);
    Affine* tot_dn = tot_up + 32;

    const int chain = p.bidir ? (int)(blockIdx.x & 1) : 0;
    const long long b = p.bidir ? (long long)(blockIdx.x >> 1) : (long long)blockIdx.x;
    const float* mag = p.mag + (size_t)b * T * F;
    const float* ang = p.angles + (size_t)b * T * F;
    float* out = p.phases + (size_t)b * T * F;
    const float abstol = p.abstol[b];
    const int mid = T / 2;
    const int n_steps = !p.bidir ? T : (chain == 0 ? T - mid : mid + 1);
    const float big = (float)(10 * F);

    float phi[kBPT];
#pragma unroll
    for (int j = 0; j < kBPT; ++j) phi[j] = 0.0f;

    for (int s = 0; s < n_steps; ++s) {
        // frames of this step: previous, current, next in walking order
        int fp, fc, fn;
        float sgn = 1.0f;
        bool store = true;
        if (!p.bidir) {
            fc = s;
            fp = s - 1;  // -1: the all-zero frame before the clip
            fn = min(s + 1, T - 1);
        } else if (chain == 0 || s == 0) {
            fc = mid + s;
            fp = fc - 1;
            fn = min(fc + 1, T - 1);
            store = chain == 0;  // chain 1 only repeats the seed step
        } else {
            fc = mid - s;
            fp = fc + 1;
            fn = max(fc - 1, 0);
            sgn = -1.0f;
        }

        float mp[kBPT], mc[kBPT], fs[kBPT];
        float wmax = -1.0f;
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            float vp = 0.0f, vc = 0.0f, vn = 0.0f;
            if (k < F) {
                if (fp >= 0) vp = __ldg(mag + (size_t)fp * F + k);
                vc = __ldg(mag + (size_t)fc * F + k);
                vn = __ldg(mag + (size_t)fn * F + k);
                wmax = fmaxf(wmax, vc);
            }
            const float yp = logf(fmaxf(vp, kPghiEps));
            const float yc = logf(fmaxf(vc, kPghiEps));
            const float yn = logf(fmaxf(vn, kPghiEps));
            const float dydt = __fmul_rn(__fsub_rn(yn, yp), 0.5f);
            mp[j] = vp;
            mc[j] = vc;
            fs[j] = __fadd_rn(__fmul_rn(sgn, __fmul_rn(-p.fmul, dydt)), kPiF);
            sYp[k] = yp;
            sYc[k] = yc;
            sM[k] = vc;
            sFs[k] = fs[j];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
        if (lane == 0) sWmax[warp] = wmax;
        __syncthreads();

        Affine up[kBPT], dn[kBPT];
        float phit[kBPT];
        bool anch[kBPT], sig[kBPT];
        int any_local = 0;
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            anch[j] = false;
            sig[j] = false;
            phit[j] = 0.0f;
            up[j] = identity_map();
            dn[j] = identity_map();
            if (k < F) {
                const int kd = k > 0 ? k - 1 : 0, ku = k < F - 1 ? k + 1 : F - 1;
                const float ck = __fmul_rn(p.carrier, (float)k);
                const float tsp = __fadd_rn(
                    __fmul_rn(__fmul_rn(__fsub_rn(sYp[ku], sYp[kd]), 0.5f), p.inv_fmul), ck);
                const float tsc = __fadd_rn(
                    __fmul_rn(__fmul_rn(__fsub_rn(sYc[ku], sYc[kd]), 0.5f), p.inv_fmul), ck);
                const float ct = __fmul_rn(sgn, __fmul_rn(__fadd_rn(tsp, tsc), 0.5f));
                phit[j] = __fadd_rn(phi[j], ct);
                // trapezoid steps of the fill, from below and from above
                up[j].b = k == 0 ? 0.0f : __fmul_rn(__fadd_rn(fs[j], sFs[k - 1]), 0.5f);
                dn[j].b = k == F - 1 ? 0.0f : -__fmul_rn(__fadd_rn(fs[j], sFs[k + 1]), 0.5f);
                sig[j] = mc[j] > abstol;
                const float m_dn = k == 0 ? -1.0f : sM[k - 1];
                const float m_up = k == F - 1 ? -1.0f : sM[k + 1];
                anch[j] = sig[j] && mp[j] > abstol && mc[j] >= m_dn && mc[j] >= m_up;
                any_local |= anch[j] ? 1 : 0;
            }
        }
        int any_anchor = __syncthreads_or(any_local);
        if (!any_anchor) {
            // onset: every audible bin equal to the frame maximum seeds
            float fmax_ = -1.0f;
            for (int w = 0; w < n_warps; ++w) fmax_ = fmaxf(fmax_, sWmax[w]);
            any_local = 0;
#pragma unroll
            for (int j = 0; j < kBPT; ++j) {
                const int k = tid * kBPT + j;
                anch[j] = k < F && sig[j] && mc[j] == fmax_;
                any_local |= anch[j] ? 1 : 0;
            }
            any_anchor = __syncthreads_or(any_local);
        }
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            if (k < F) {
                const float a0 = anch[j] ? 0.0f : 1.0f;
                up[j].a = a0;
                dn[j].a = a0;
                up[j].d = a0;
                dn[j].d = a0;
                if (anch[j]) {
                    up[j].b = phit[j];
                    dn[j].b = phit[j];
                }
            }
        }
        block_scan<kBPT, true>(up, tot_up, lane, warp, n_warps);
        block_scan<kBPT, false>(dn, tot_dn, lane, warp, n_warps);
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            if (k < F) {
                const float du = up[j].a == 0.0f ? up[j].d : big;
                const float dd = dn[j].a == 0.0f ? dn[j].d : big;
                float filled = du <= dd ? up[j].b : dn[j].b;  // a tie takes the fill from below
                if (!any_anchor) filled = 0.0f;
                float v = anch[j] ? phit[j] : filled;
                if (!sig[j]) v = __ldg(ang + (size_t)fc * F + k);
                phi[j] = v;
                if (store) out[(size_t)fc * F + k] = v;
            }
        }
        // the scans' barriers lie between this step's reads of the shared rows
        // and the next step's writes
    }
}

struct RtPghiArgs {
    const float* mag;         // (B, T, F), T a multiple of T_c
    const float* angles;      // (B, Ta, F) phases of the silent bins, Ta >= T
    const float* prev_mag;    // (B, 2, F) carried magnitude frames, or null: two zero frames
    const float* prev_phase;  // (B, F) carried phase, or null: zeros
    float* phases;            // (B, T, F) out
    int T, Ta, F, T_c;
    float tol;            // threshold relative to the chunk's maximum
    float fmul;           // gamma / (hop n_fft)
    float inv_fmul;       // 1 / fmul
    float carrier;        // 2 pi hop / n_fft
    int S, P, C;          // frames a stage, producer and chain warps
};

constexpr int kRtE = 4;               // bins a lane owns in a tile of the fill's scans
constexpr int kRtTile = 32 * kRtE;    // bins one warp's scan covers at a time
constexpr int kRtWarps = 24;          // warps of the block, at most
constexpr int kRtStage = 16;          // frames a stage, at most (each has an anchor flag word)
constexpr int kRtBufs = 2;            // stage buffers
constexpr int kRtNone = 8192;         // "no anchor on this side" (more than any distance)
constexpr int kRtBatch = 8;           // bins a chain thread takes at once
constexpr short kRtSig = 1, kRtAnchor = 2;  // a bin's flags in the source row while it is planned
// named barriers (0 is __syncthreads, which this kernel does not use)
constexpr int kBarProd = 1, kBarChain = 2, kBarFull = 3, kBarFree = 5;

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__host__ __device__ inline int rt_row(int F) { return (F + 3) & ~3; }

// Shared memory, in rows of F rounded up to 4 (so that every row starts
// 16-byte aligned, 8 for the int16 rows): the producers' logarithms of a
// stage's frames and the two before it (S + 2 rows; the first S then hold the
// frequency derivatives, then the steps up), the chain's two phase rows, 64
// words of chunk maxima and anchor flags; then kRtBufs stage buffers, each S
// float segment-sum rows (the angles on arrival), S float ct rows and the
// magnitudes of the frame before the stage (the chunk boundary's re-wrap),
// and (after all the float rows) S int16 source rows a buffer (the bins'
// flags while the stage is planned).
__host__ __device__ inline size_t rt_pghi_smem_bytes(int F, int S) {
    const size_t row = (size_t)rt_row(F);
    return sizeof(float) * ((size_t)(S + 4) * row + 64) +
           (size_t)kRtBufs * row * ((size_t)S * (2 * sizeof(float) + sizeof(short)) + sizeof(float));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// A segmented sum over a span of bins: f, the span holds an anchor (a head);
// b, the sum of the steps since the last one.
struct SegSum {
    int f;
    float b;
};

// Apply `l` (earlier) then `r`: a head in `r` restarts the sum.
__device__ __forceinline__ SegSum seg_compose(const SegSum& l, const SegSum& r) {
    SegSum o;
    o.f = l.f | r.f;
    o.b = r.f ? r.b : __fadd_rn(l.b, r.b);
    return o;
}

// Value of lane `lane - delta` (kUp) or `lane + delta`, an empty span outside the warp.
template <bool kUp>
__device__ __forceinline__ SegSum seg_shift(const SegSum& x, int delta, int lane) {
    SegSum o;
    if (kUp) {
        o.f = __shfl_up_sync(0xffffffffu, x.f, delta);
        o.b = __shfl_up_sync(0xffffffffu, x.b, delta);
        if (lane < delta) o = SegSum{0, 0.0f};
    } else {
        o.f = __shfl_down_sync(0xffffffffu, x.f, delta);
        o.b = __shfl_down_sync(0xffffffffu, x.b, delta);
        if (lane + delta > 31) o = SegSum{0, 0.0f};
    }
    return o;
}

// Inclusive Kogge-Stone over the lanes, towards higher (kUp) or lower lanes.
template <bool kUp>
__device__ __forceinline__ SegSum seg_warp_scan(SegSum x, int lane) {
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) x = seg_compose(seg_shift<kUp>(x, s, lane), x);
    return x;
}

__device__ __forceinline__ SegSum seg_lane(const SegSum& x, int src) {
    return SegSum{__shfl_sync(0xffffffffu, x.f, src), __shfl_sync(0xffffffffu, x.b, src)};
}

__device__ __forceinline__ void load4(const float* p, float (&v)[kRtE]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// The frequency derivative of the phase at a bin, from the logarithms of its
// frame and the two before (the causal time stencil).
__device__ __forceinline__ float rt_fs(const RtPghiArgs& p, float yc, float y1, float y2) {
    const float dydt = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(3.0f, yc), __fmul_rn(4.0f, y1)), y2), 0.5f);
    return __fadd_rn(__fmul_rn(-p.fmul, dydt), kPiF);
}

// The time step at bin k from its neighbours' logarithms (ylo at k - 1, yhi
// at k + 1, clamped at the ends by the caller).
__device__ __forceinline__ float rt_ts(const RtPghiArgs& p, float ylo, float yhi, int k) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(yhi, ylo), 0.5f), p.inv_fmul),
                     __fmul_rn(p.carrier, (float)k));
}

// One frame's plan, by one producer warp (rt_fill_plan in the plain version,
// ops/cuda/stream_step.py), from the stage's shared rows.  On entry fs_r
// holds the frame's frequency derivatives, src_r its bins' flags (sig |
// anchor << 1, by the peak rule), seg_r its angles; `any` says whether the
// peak rule found an anchor.  Writes the source bin (src_r) and the segment
// sum, or the constant, of every bin (seg_r).
//   A. without an anchor, the onset rule: every audible bin equal to the
//      frame maximum (mrow, the frame's magnitudes in device memory);
// then over the frame's 128-bin tiles, lane `lane` holding bins 128 i + 4
// lane .. + 3 (its neighbours' values through shuffles and the carries):
//   C. tiles upward: the step up (fs of the bin and the one below, into
//      fs_r), the segment sum from the nearest anchor below (into seg_r at
//      the audible bins; a silent bin keeps its angle) and that anchor's bin
//      (packed into src_r with the flags);
//   D. tiles downward: the step down (minus the next bin's step up), the
//      segment sum from above, the source by the distance rule (a tie takes
//      the anchor below), the constant of a silent bin or of a frame without
//      an anchor.
__device__ __forceinline__ void rt_plan_frame(const float* mrow, int any, float* fs_r, int F, short* src_r,
                                              float* seg_r, int lane) {
    const int nt = (F + kRtTile - 1) / kRtTile;
    const int row = rt_row(F);

    // A.
    if (!any) {
        float fmax = -1.0f;
        for (int k = lane; k < F; k += 32) fmax = fmaxf(fmax, __ldg(mrow + k));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) fmax = fmaxf(fmax, __shfl_xor_sync(0xffffffffu, fmax, o));
        for (int k = lane; k < F; k += 32) {
            const bool an = (src_r[k] & kRtSig) && __ldg(mrow + k) == fmax;
            any |= an ? 1 : 0;
            if (an) src_r[k] = kRtSig | kRtAnchor;
        }
        any = __any_sync(0xffffffffu, any);
        __syncwarp();
    }

    // C.
    SegSum carry{0, 0.0f};
    int cbelow = -1;
    float fs_left = 0.0f;  // fs of the last bin of the tile below
    for (int i = 0; i < nt; ++i) {
        const int k0 = i * kRtTile + kRtE * lane;
        const bool act = k0 < row;
        float fs[kRtE] = {0.0f, 0.0f, 0.0f, 0.0f}, an4[kRtE] = {0.0f, 0.0f, 0.0f, 0.0f};
        short fl[kRtE] = {0, 0, 0, 0};
        if (act) {
            load4(fs_r + k0, fs);
            load4(seg_r + k0, an4);
            const short4 w = *reinterpret_cast<const short4*>(src_r + k0);
            fl[0] = w.x; fl[1] = w.y; fl[2] = w.z; fl[3] = w.w;
        }
        float below_fs = __shfl_up_sync(0xffffffffu, fs[kRtE - 1], 1);
        if (lane == 0) below_fs = fs_left;
        SegSum own[kRtE];
        float sup[kRtE];
        int bl[kRtE];
#pragma unroll
        for (int e = 0; e < kRtE; ++e) {
            const int k = k0 + e;
            const int an = (k < F && (fl[e] & kRtAnchor)) ? 1 : 0;
            const float fprev = e == 0 ? below_fs : fs[e - 1];
            sup[e] = (k == 0 || k >= F) ? 0.0f : __fmul_rn(__fadd_rn(fs[e], fprev), 0.5f);
            const SegSum x{an, an ? 0.0f : sup[e]};
            own[e] = e == 0 ? x : seg_compose(own[e - 1], x);
            bl[e] = an ? k : (e == 0 ? -1 : bl[e - 1]);
        }
        const SegSum incl = seg_warp_scan<true>(own[kRtE - 1], lane);
        const SegSum before = seg_compose(carry, seg_shift<true>(incl, 1, lane));
        int lmax = bl[kRtE - 1];
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, lmax, s);
            if (lane >= s) lmax = max(lmax, o);
        }
        int lex = __shfl_up_sync(0xffffffffu, lmax, 1);
        if (lane == 0) lex = -1;
        const int bfrom = max(cbelow, lex);
        if (act) {
            float su[kRtE];
            short w[kRtE];
#pragma unroll
            for (int e = 0; e < kRtE; ++e) {
                su[e] = (fl[e] & kRtSig) ? seg_compose(before, own[e]).b : an4[e];
                w[e] = (short)(fl[e] | ((max(bfrom, bl[e]) + 1) << 2));
            }
            *reinterpret_cast<float4*>(fs_r + k0) = make_float4(sup[0], sup[1], sup[2], sup[3]);
            *reinterpret_cast<float4*>(seg_r + k0) = make_float4(su[0], su[1], su[2], su[3]);
            *reinterpret_cast<short4*>(src_r + k0) = make_short4(w[0], w[1], w[2], w[3]);
        }
        carry = seg_compose(carry, seg_lane(incl, 31));
        cbelow = max(cbelow, __shfl_sync(0xffffffffu, lmax, 31));
        fs_left = __shfl_sync(0xffffffffu, fs[kRtE - 1], 31);
    }

    // D.
    carry = SegSum{0, 0.0f};
    int cabove = kRtNone;
    float sup_right = 0.0f;  // the step up of bin 0 of the tile above
    for (int i = nt - 1; i >= 0; --i) {
        const int k0 = i * kRtTile + kRtE * lane;
        const bool act = k0 < row;
        float sup[kRtE] = {0.0f, 0.0f, 0.0f, 0.0f}, sv[kRtE] = {0.0f, 0.0f, 0.0f, 0.0f};
        short w[kRtE] = {0, 0, 0, 0};
        if (act) {
            load4(fs_r + k0, sup);
            load4(seg_r + k0, sv);
            const short4 q = *reinterpret_cast<const short4*>(src_r + k0);
            w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
        }
        float sup_up = __shfl_down_sync(0xffffffffu, sup[0], 1);
        if (lane == 31) sup_up = sup_right;
        SegSum own[kRtE];
        int ab[kRtE];
#pragma unroll
        for (int e = kRtE - 1; e >= 0; --e) {
            const int k = k0 + e;
            const int an = (k < F && (w[e] & kRtAnchor)) ? 1 : 0;
            const float nb = e < kRtE - 1 ? sup[e + 1] : sup_up;
            const float sdn = k < F - 1 ? -nb : 0.0f;
            const SegSum x{an, an ? 0.0f : sdn};
            own[e] = e == kRtE - 1 ? x : seg_compose(own[e + 1], x);
            ab[e] = an ? k : (e == kRtE - 1 ? kRtNone : ab[e + 1]);
        }
        const SegSum incl = seg_warp_scan<false>(own[0], lane);
        const SegSum before = seg_compose(carry, seg_shift<false>(incl, 1, lane));
        int lmin = ab[0];
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int o = __shfl_down_sync(0xffffffffu, lmin, s);
            if (lane + s <= 31) lmin = min(lmin, o);
        }
        int lex = __shfl_down_sync(0xffffffffu, lmin, 1);
        if (lane == 31) lex = kRtNone;
        const int afrom = min(cabove, lex);
        if (act) {
            short sr[kRtE];
#pragma unroll
            for (int e = 0; e < kRtE; ++e) {
                const int k = k0 + e;
                sr[e] = -1;
                // a silent bin keeps its angle; an audible one holds the sum from below
                if (k < F && (w[e] & kRtSig)) {
                    if (w[e] & kRtAnchor) {
                        sr[e] = (short)k;
                        sv[e] = -0.0f;
                    } else if (!any) {
                        sv[e] = 0.0f;
                    } else {
                        const int below = (w[e] >> 2) - 1;
                        const int above = min(afrom, ab[e]);
                        const int du = below >= 0 ? k - below : kRtNone;
                        const int dd = above < kRtNone ? above - k : kRtNone;
                        if (du <= dd) {
                            sr[e] = (short)below;
                        } else {
                            sr[e] = (short)above;
                            sv[e] = seg_compose(before, own[e]).b;
                        }
                    }
                }
            }
            *reinterpret_cast<float4*>(seg_r + k0) = make_float4(sv[0], sv[1], sv[2], sv[3]);
            *reinterpret_cast<short4*>(src_r + k0) = make_short4(sr[0], sr[1], sr[2], sr[3]);
        }
        carry = seg_compose(carry, seg_lane(incl, 0));
        cabove = min(cabove, __shfl_sync(0xffffffffu, lmin, 0));
        sup_right = __shfl_sync(0xffffffffu, sup[0], 0);
    }
}

// One block walks one session.  Warps 0 .. P - 1 produce a stage (S frames
// of one chunk) at a time, all of them together, with barriers of their own
// between the steps: they copy (cp.async) the magnitudes of the stage's
// frames and the two before it and the stage's angles (into the free
// buffer's segment-sum rows) into shared memory; take the chunk's maximum
// where the stage starts a chunk, and the logarithms; ct, lanes on
// consecutive bins (into the buffer's ct rows); the frequency derivatives in
// place of the logarithms; then plan a frame a warp (rt_plan_frame).  Warps
// P .. P + C - 1 are the chain: per frame, for up to 8 bins a thread at once,
// one gather of the previous frame's phases and of ct, two adds and a store,
// then a barrier of the chain's warps; at a chunk boundary the re-wrap first.
// Stages hand over by named barriers: a buffer is full when every producer
// thread has arrived, free again when every chain thread has.
__global__ void __launch_bounds__(32 * kRtWarps) rt_pghi_phases_kernel(RtPghiArgs p) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int F = p.F, T_c = p.T_c, S = p.S;
    const int row = rt_row(F);
    const int n_all = blockDim.x;
    const int n_prod = 32 * p.P;

    float* sY = smem;                                 // (S + 2) x row: frames s0 - 2 ..
    float* sPhi = sY + (size_t)(S + 2) * row;         // 2 x row
    float* sMax = sPhi + 2 * (size_t)row;             // 32
    int* sAny = reinterpret_cast<int*>(sMax + 32);    // 32: a flag a frame of the stage
    float* sStage = sMax + 64;                        // kRtBufs x (seg, ct: S x row; m_prev: row)
    const size_t buf_floats = (size_t)(2 * S + 1) * row;
    short* sSrc = reinterpret_cast<short*>(sStage + (size_t)kRtBufs * buf_floats);

    const long long b = blockIdx.x;
    const float* mag = p.mag + (size_t)b * p.T * F;
    const float* prev = p.prev_mag != nullptr ? p.prev_mag + (size_t)b * 2 * F : nullptr;
    const int per_chunk = (T_c + S - 1) / S;
    const int n_stages = (p.T / T_c) * per_chunk;
    // the magnitude row of frame f >= -2 (null: a zero frame before a fresh session)
    auto mag_row = [&](int f) -> const float* {
        if (f >= 0) return mag + (size_t)f * F;
        return prev != nullptr ? prev + (size_t)(f + 2) * F : nullptr;
    };

    if (warp < p.P) {
        // ---- producers
        const float* ang = p.angles + (size_t)b * p.Ta * F;
        // the maximum of the chunk that starts at frame c0, over (T_c, F),
        // into sMax (a partial a warp): loads of every producer thread in
        // flight at once, so that it also brings the chunk into L2
        auto chunk_max = [&](int c0) {
            const float* cmag = mag + (size_t)c0 * F;
            const int n = T_c * F;
            float c8[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            for (int i = tid; i < n; i += 8 * n_prod) {
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int ii = i + u * n_prod;
                    if (ii < n) c8[u] = fmaxf(c8[u], __ldg(cmag + ii));
                }
            }
            float c = 0.0f;
#pragma unroll
            for (int u = 0; u < 8; ++u) c = fmaxf(c, c8[u]);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, o));
            if (lane == 0) sMax[warp] = c;
        };
        auto threshold = [&]() {
            float mx = 0.0f;
            for (int w = 0; w < p.P; ++w) mx = fmaxf(mx, sMax[w]);
            return fmaxf(__fmul_rn(p.tol, mx), kPghiEps);
        };
        chunk_max(0);
        bar_sync(kBarProd, n_prod);
        float thr = threshold(), thr_next = thr;
        int s_prev = 0;  // frames of the previous stage
        for (int g = 0; g < n_stages; ++g) {
            const int buf = g % kRtBufs;
            const int j = g % per_chunk;
            const int s0 = (g / per_chunk) * T_c + j * S;
            const int Sg = min(S, T_c - j * S);
            const bool next_chunk = j == per_chunk - 1 && g + 1 < n_stages;
            float* seg_b = sStage + (size_t)buf * buf_floats;
            float* ct_b = seg_b + (size_t)S * row;
            float* mprev_b = ct_b + (size_t)S * row;
            short* src_b = sSrc + (size_t)buf * S * row;
            if (j == 0) thr = thr_next;
            // the logarithms of the two frames before the stage: the previous
            // stage's last two rows, or the carried history
            for (int k = tid; k < F; k += n_prod) {
                float y0, y1;
                if (g > 0) {
                    y0 = sY[(size_t)s_prev * row + k];
                    y1 = sY[(size_t)(s_prev + 1) * row + k];
                } else {
                    y0 = logf(fmaxf(prev != nullptr ? __ldg(prev + k) : 0.0f, kPghiEps));
                    y1 = logf(fmaxf(prev != nullptr ? __ldg(prev + F + k) : 0.0f, kPghiEps));
                }
                sY[k] = y0;
                sY[row + k] = y1;
            }
            s_prev = Sg;
            bar_sync(kBarProd, n_prod);
            // the stage's buffer is free once the chain has walked it
            if (g >= kRtBufs) bar_sync(kBarFree + buf, n_all);
            for (int q = warp; q < Sg; q += p.P) {
                const float* ag = ang + (size_t)(s0 + q) * F;
                float* ar = seg_b + (size_t)q * row;
                for (int k = lane; k < F; k += 32) cp_async4(ar + k, ag + k);
            }
            if (j == 0 && s0 > 0) {
                const float* mr = mag + (size_t)(s0 - 1) * F;
                for (int k = tid; k < F; k += n_prod) cp_async4(mprev_b + k, mr + k);
            }
            // lanes on consecutive bins: the logarithms of the stage's frames
            // and the flags of their bins by the peak rule
            for (int q = warp; q < Sg; q += p.P) {
                const float* mr = mag + (size_t)(s0 + q) * F;
                const float* m1r = mag_row(s0 + q - 1);
                float* yr = sY + (size_t)(q + 2) * row;
                short* fq = src_b + (size_t)q * row;
                int any = 0;
                for (int k0 = lane; k0 < F; k0 += kRtBatch * 32) {
                    float m[kRtBatch], m1[kRtBatch], mdn[kRtBatch], mup[kRtBatch];
#pragma unroll
                    for (int u = 0; u < kRtBatch; ++u) {
                        const int k = k0 + 32 * u;
                        const bool in = k < F;
                        m[u] = in ? __ldg(mr + k) : 0.0f;
                        m1[u] = in && m1r != nullptr ? __ldg(m1r + k) : 0.0f;
                        mdn[u] = in && k > 0 ? __ldg(mr + k - 1) : -1.0f;
                        mup[u] = in && k < F - 1 ? __ldg(mr + k + 1) : -1.0f;
                    }
#pragma unroll
                    for (int u = 0; u < kRtBatch; ++u) {
                        const int k = k0 + 32 * u;
                        if (k < F) {
                            yr[k] = logf(fmaxf(m[u], kPghiEps));
                            const bool sg = m[u] > thr;
                            const bool an = sg && m1[u] > thr && m[u] >= mdn[u] && m[u] >= mup[u];
                            any |= an ? 1 : 0;
                            fq[k] = (short)((sg ? kRtSig : 0) | (an ? kRtAnchor : 0));
                        }
                    }
                }
                any = __any_sync(0xffffffffu, any);
                if (lane == 0) sAny[q] = any;
            }
            // the next chunk's threshold, a stage ahead
            if (next_chunk) chunk_max(s0 + Sg);
            cp_async_wait_all();
            bar_sync(kBarProd, n_prod);
            if (next_chunk) thr_next = threshold();
            // ct from the time steps of each frame and the one before
            for (int q = warp; q < Sg; q += p.P) {
                const float* yc = sY + (size_t)(q + 2) * row;
                const float* y1 = yc - row;
                float* ctq = ct_b + (size_t)q * row;
                for (int k = lane; k < F; k += 32) {
                    const int kd = k > 0 ? k - 1 : 0, ku = k < F - 1 ? k + 1 : F - 1;
                    ctq[k] = __fmul_rn(__fadd_rn(rt_ts(p, y1[kd], y1[ku], k), rt_ts(p, yc[kd], yc[ku], k)), 0.5f);
                }
            }
            bar_sync(kBarProd, n_prod);
            // fs of frame s0 + q in place of the logarithms of frame s0 + q - 2,
            // each bin by one thread in order of q; the last two rows stay
            for (int k = tid; k < F; k += n_prod) {
                for (int q = 0; q < Sg; ++q) {
                    float* y = sY + (size_t)q * row + k;
                    *y = rt_fs(p, y[2 * row], y[row], y[0]);
                }
            }
            bar_sync(kBarProd, n_prod);
            for (int q = warp; q < Sg; q += p.P) {
                rt_plan_frame(mag + (size_t)(s0 + q) * F, sAny[q], sY + (size_t)q * row, F,
                              src_b + (size_t)q * row, seg_b + (size_t)q * row, lane);
            }
            bar_arrive(kBarFull + buf, n_all);
            // the logarithms, the flags and the maxima are rewritten by the next stage
            bar_sync(kBarProd, n_prod);
        }
    } else {
        // ---- the chain
        const int ct_id = tid - n_prod;
        const int n_chain = n_all - n_prod;
        float* out = p.phases + (size_t)b * p.T * F;
        float* cur = sPhi;
        float* nxt = sPhi + row;
        for (int k = ct_id; k < F; k += n_chain)
            cur[k] = p.prev_phase != nullptr ? __ldg(p.prev_phase + (size_t)b * F + k) : 0.0f;
        bar_sync(kBarChain, n_chain);
        for (int g = 0; g < n_stages; ++g) {
            const int buf = g % kRtBufs;
            const int j = g % per_chunk;
            const int s0 = (g / per_chunk) * T_c + j * S;
            const int Sg = min(S, T_c - j * S);
            const float* seg_b = sStage + (size_t)buf * buf_floats;
            const float* ct_b = seg_b + (size_t)S * row;
            const float* mprev_b = ct_b + (size_t)S * row;
            const short* src_b = sSrc + (size_t)buf * S * row;
            bar_sync(kBarFull + buf, n_all);
            if (s0 > 0 && j == 0) {
                // the carry the chunked loop hands over: the angle of the
                // committed spectrum's last frame
                for (int k0 = ct_id; k0 < F; k0 += kRtBatch * n_chain) {
#pragma unroll
                    for (int u = 0; u < kRtBatch; ++u) {
                        const int k = k0 + u * n_chain;
                        if (k < F) {
                            float sn, cs;
                            sincosf(cur[k], &sn, &cs);
                            const float m = mprev_b[k];
                            cur[k] = atan2f(__fmul_rn(m, sn), __fmul_rn(m, cs));
                        }
                    }
                }
                bar_sync(kBarChain, n_chain);
            }
            for (int q = 0; q < Sg; ++q) {
                const short* sr = src_b + (size_t)q * row;
                const float* sg = seg_b + (size_t)q * row;
                const float* cr = ct_b + (size_t)q * row;
                float* o = out + (size_t)(s0 + q) * F;
                for (int k0 = ct_id; k0 < F; k0 += kRtBatch * n_chain) {
                    int s[kRtBatch];
                    float gv[kRtBatch], cv[kRtBatch], pv[kRtBatch];
#pragma unroll
                    for (int u = 0; u < kRtBatch; ++u) {
                        const int k = k0 + u * n_chain;
                        s[u] = k < F ? sr[k] : -1;
                        gv[u] = k < F ? sg[k] : 0.0f;
                    }
#pragma unroll
                    for (int u = 0; u < kRtBatch; ++u) {
                        cv[u] = s[u] >= 0 ? cr[s[u]] : 0.0f;
                        pv[u] = s[u] >= 0 ? cur[s[u]] : 0.0f;
                    }
#pragma unroll
                    for (int u = 0; u < kRtBatch; ++u) {
                        const int k = k0 + u * n_chain;
                        if (k < F) {
                            const float v = s[u] >= 0 ? __fadd_rn(__fadd_rn(pv[u], cv[u]), gv[u]) : gv[u];
                            nxt[k] = v;
                            o[k] = v;
                        }
                    }
                }
                bar_sync(kBarChain, n_chain);
                float* tmp = cur;
                cur = nxt;
                nxt = tmp;
            }
            if (g + kRtBufs < n_stages) bar_arrive(kBarFree + buf, n_all);
        }
    }
}

struct SynthArgs {
    const float* mag;     // (B, T, F)
    const float* phases;  // (B, T, F)
    const float* basis;   // (overlap, Kp, hop)
    float* out;           // (B, (T + overlap - 1) * hop)
    int T, F, hop, overlap, Kp, n_tiles;
};

__host__ __device__ inline size_t pghi_synth_smem_bytes(int rows, int overlap, int Kp) {
    return sizeof(float) * ((size_t)(rows + overlap - 1) * Kp + (size_t)kSynKC * kSynCols);
}

template <int kRPT>
__global__ void __launch_bounds__(kSynThreads) pghi_synthesize_kernel(SynthArgs p) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int T = p.T, F = p.F, Kp = p.Kp, ov = p.overlap;
    constexpr int R = 8 * kRPT;
    float* S = smem;
    float* Bst = S + (size_t)(R + ov - 1) * Kp;

    const long long blk = blockIdx.x;
    const long long b = blk / p.n_tiles;
    const int j0 = (int)(blk - b * p.n_tiles) * R;
    const float* mag = p.mag + (size_t)b * T * F;
    const float* ph = p.phases + (size_t)b * T * F;

    for (int q = 0; q < R + ov - 1; ++q) {
        const int f = j0 - (ov - 1) + q;
        float* row = S + (size_t)q * Kp;
        if (f >= 0 && f < T) {
            for (int k = tid; k < F; k += kSynThreads) {
                const float m = __ldg(mag + (size_t)f * F + k);
                float sn, cs;
                sincosf(__ldg(ph + (size_t)f * F + k), &sn, &cs);
                row[k] = m * cs;
                row[F + k] = m * sn;
            }
            for (int k = 2 * F + tid; k < Kp; k += kSynThreads) row[k] = 0.0f;
        } else {
            for (int k = tid; k < Kp; k += kSynThreads) row[k] = 0.0f;
        }
    }
    // synth_ola_tile starts with a barrier before it reads S
    const int n_chunks = T + ov - 1;
    synth_ola_tile<kRPT>(S, Bst, p.basis, Kp, p.hop, ov, j0, n_chunks,
                         p.out + (size_t)b * n_chunks * p.hop);
}

struct SynthFftArgs {
    const float* mag;     // (B, T, F)
    const float* phases;  // (B, T, F)
    const float* wsyn;    // (n_fft,): the synthesis window / n_fft
    const float* fft_tw;  // (2, n_fft): (cos, -sin)(2 pi j / n_fft)
    float* out;           // (B, (T + overlap - 1) * hop)
    int T, F, hop, overlap, rows, teams, n_tiles;
};

// The samples of `rows` chunks, then frames_rfft's area, whose window slot
// holds wsyn.
__host__ __device__ inline size_t pghi_synth_fft_smem_floats(int rows, int hop, int n, int teams) {
    return (size_t)rows * hop + fft_smem_floats(n, teams);
}

// K's synthesis on the FFT route: a block owns one clip and the output chunks
// c0 .. c0 + rows - 1 (c0 and rows multiples of 2 overlap).  frames_irfft
// runs the frames c0 - 2 overlap .. c0 + rows - 1 with pair stride overlap:
// local frame r is frame c0 - 2 overlap + r, so the block's pairs are the
// clip's (f, f + overlap) for f mod 2 overlap < overlap; the first group's
// first frames, and frames outside [0, T), are synthesized or loaded as zeros
// but add nothing.  Each sample collects its frames in class order f mod
// overlap.
__global__ void __launch_bounds__(kThreads, 2) pghi_synthesize_fft_kernel(SynthFftArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int R = a.rows, T = a.T, F = a.F, hop = a.hop, ov = a.overlap;
    const int n = ov * hop;
    float* samples = smem;  // [R][hop]
    const FftSmem fs = carve_fft(samples + (size_t)R * hop, n);
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int c0 = (int)(blk - b * a.n_tiles) * R;
    const int n_chunks = T + ov - 1;
    const size_t bofs = (size_t)b * T * F;
    fft_stage(a.wsyn, a.fft_tw, fs, n);  // wsyn in the window's slot
    for (int i = threadIdx.x; i < R * hop; i += kThreads) samples[i] = 0.0f;
    const int f0 = c0 - 2 * ov;
    // frames_irfft starts with a barrier and ends with one
    frames_irfft(
        min(R + 2 * ov, T - f0), ov, n, fs, fs.win, a.teams,
        [&](int r, int k, float& re, float& im) {
            const int f = f0 + r;
            if (f < 0) {  // the first block's leading group: no frame
                re = 0.0f;
                im = 0.0f;
                return;
            }
            const size_t o = bofs + (size_t)f * F + k;
            const float m = __ldg(a.mag + o);
            float sn, cs;
            sincosf(__ldg(a.phases + o), &sn, &cs);
            re = __fmul_rn(m, cs);
            im = __fmul_rn(m, sn);
        },
        [&](int r, int i, float v) {
            const int f = f0 + r;
            const int pos = (f - c0) * hop + i;
            if (f >= 0 && pos >= 0 && pos < R * hop) samples[pos] = __fadd_rn(samples[pos], v);
        });
    float* out = a.out + (size_t)b * n_chunks * hop + (size_t)c0 * hop;
    const int n_out = min(R, n_chunks - c0) * hop;
    for (int i = threadIdx.x; i < n_out; i += kThreads) out[i] = samples[i];
}

template <typename K>
static cudaError_t pghi_allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

}  // namespace att

extern "C" {

long long att_pghi_synth_smem_bytes(int rows, int overlap, int Kp) {
    return (long long)att::pghi_synth_smem_bytes(rows, overlap, Kp);
}

long long att_pghi_synth_fft_smem_bytes(int rows, int hop, int n_fft, int teams) {
    return (long long)(att::pghi_synth_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float));
}

// mag, angles, phases: (B, T, F) float32; abstol: (B,).  bpt bins per thread
// (1, 2 or 4) with ceil(F / (32 bpt)) warps per block, at most 32.  bidir
// runs two blocks per clip and needs T >= 4.  Returns a cudaError_t.
int att_pghi_phases(const float* mag, const float* angles, const float* abstol, float* phases,
                    long long B, int T, int F, float fmul, float inv_fmul, float carrier,
                    int bidir, int bpt, void* stream) {
    using namespace att;
    if (B < 1 || T < 1 || F < 2 || (bidir && T < 4)) return (int)cudaErrorInvalidValue;
    const int n_warps = (F + 32 * bpt - 1) / (32 * bpt);
    if (n_warps > 32 || (bpt != 1 && bpt != 2 && bpt != 4)) return (int)cudaErrorInvalidValue;
    PghiArgs a;
    a.mag = mag;
    a.angles = angles;
    a.abstol = abstol;
    a.phases = phases;
    a.T = T;
    a.F = F;
    a.bidir = bidir;
    a.fmul = fmul;
    a.inv_fmul = inv_fmul;
    a.carrier = carrier;
    const int threads = 32 * n_warps;
    const size_t smem = pghi_phases_smem_bytes(threads * bpt);
    dim3 grid((unsigned)(bidir ? 2 * B : B));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_PHASES(BPT)                                              \
    do {                                                                    \
        err = pghi_allow_smem(pghi_phases_kernel<BPT>, smem);               \
        if (err != cudaSuccess) return (int)err;                            \
        pghi_phases_kernel<BPT><<<grid, threads, smem, s>>>(a);             \
    } while (0)
    if (bpt == 1) ATT_LAUNCH_PHASES(1);
    else if (bpt == 2) ATT_LAUNCH_PHASES(2);
    else ATT_LAUNCH_PHASES(4);
#undef ATT_LAUNCH_PHASES
    return (int)cudaGetLastError();
}

long long att_rt_pghi_smem_bytes(int F, int S) {
    return (long long)att::rt_pghi_smem_bytes(F, S);
}

// mag, phases: (B, T, F) float32 with T a multiple of T_c; angles (B, Ta, F),
// Ta >= T.  prev_mag (B, 2, F) and prev_phase (B, F) seed the session with a
// carried history (both or neither; null: a fresh session).  The block:
// stages of S frames (1 <= S <= min(T_c, 16)) in two buffers, P producer
// warps (at most S) and C chain warps, P + C <= 24; one block per session.
// F from 2 to 4096.  Returns a cudaError_t.
int att_rt_pghi_phases(const float* mag, const float* angles, const float* prev_mag,
                       const float* prev_phase, float* phases, long long B, int T, int Ta, int F,
                       int T_c, float tol, float fmul, float inv_fmul, float carrier, int S,
                       int P, int C, void* stream) {
    using namespace att;
    if (B < 1 || T < 1 || F < 2 || F > 4096 || T_c < 1 || T % T_c != 0 || Ta < T ||
        (prev_mag == nullptr) != (prev_phase == nullptr) || S < 1 || S > T_c ||
        S > kRtStage || P < 1 || P > S || C < 1 || P + C > kRtWarps) {
        return (int)cudaErrorInvalidValue;
    }
    RtPghiArgs a;
    a.mag = mag;
    a.angles = angles;
    a.prev_mag = prev_mag;
    a.prev_phase = prev_phase;
    a.phases = phases;
    a.T = T;
    a.Ta = Ta;
    a.F = F;
    a.T_c = T_c;
    a.tol = tol;
    a.fmul = fmul;
    a.inv_fmul = inv_fmul;
    a.carrier = carrier;
    a.S = S;
    a.P = P;
    a.C = C;
    const size_t smem = rt_pghi_smem_bytes(F, S);
    cudaError_t err = pghi_allow_smem(rt_pghi_phases_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    rt_pghi_phases_kernel<<<dim3((unsigned)B), 32 * (P + C), smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// mag, phases: (B, T, F); basis: (overlap, Kp, hop) with Kp a multiple of 32,
// Kp >= 2F; out: (B, (T + overlap - 1) * hop), every sample written.  rows
// output chunks per block: 40, 16 or 8.  hop a multiple of 4.
int att_pghi_synthesize(const float* mag, const float* phases, const float* basis, float* out,
                        long long B, int T, int F, int hop, int overlap, int Kp, int rows,
                        void* stream) {
    using namespace att;
    if (B < 1 || T < 1 || hop % 4 != 0 || Kp % kSynKC != 0 || Kp < 2 * F || overlap < 1 ||
        (rows != 40 && rows != 16 && rows != 8)) {
        return (int)cudaErrorInvalidValue;
    }
    SynthArgs a;
    a.mag = mag;
    a.phases = phases;
    a.basis = basis;
    a.out = out;
    a.T = T;
    a.F = F;
    a.hop = hop;
    a.overlap = overlap;
    a.Kp = Kp;
    a.n_tiles = (T + overlap - 1 + rows - 1) / rows;
    const size_t smem = pghi_synth_smem_bytes(rows, overlap, Kp);
    dim3 grid((unsigned)(B * a.n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_SYNTH(RPT)                                               \
    do {                                                                    \
        err = pghi_allow_smem(pghi_synthesize_kernel<RPT>, smem);           \
        if (err != cudaSuccess) return (int)err;                            \
        pghi_synthesize_kernel<RPT><<<grid, kSynThreads, smem, s>>>(a);     \
    } while (0)
    if (rows == 40) ATT_LAUNCH_SYNTH(5);
    else if (rows == 16) ATT_LAUNCH_SYNTH(2);
    else ATT_LAUNCH_SYNTH(1);
#undef ATT_LAUNCH_SYNTH
    return (int)cudaGetLastError();
}

// K's synthesis on the FFT route.  mag, phases: (B, T, F) float32 with F =
// n_fft / 2 + 1, n_fft = overlap * hop a power of two from 64 to 4096; wsyn
// (n_fft,) the synthesis window / n_fft; fft_tw (2, n_fft) = (cos, -sin)(2 pi
// j / n_fft); out: (B, (T + overlap - 1) * hop), every sample written.  rows
// output chunks per block, a multiple of 2 overlap; 1 <= teams <= 4096 /
// n_fft FFTs side by side.  Returns a cudaError_t.
int att_pghi_synthesize_fft(const float* mag, const float* phases, const float* wsyn,
                            const float* fft_tw, float* out, long long B, int T, int F, int hop,
                            int overlap, int rows, int teams, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    if (B < 1 || T < 1 || overlap < 2 || !fft_covers(n_fft) || F != n_fft / 2 + 1 || rows < 1 ||
        rows % (2 * overlap) != 0 || teams < 1 || teams > fft_max_teams(n_fft)) {
        return (int)cudaErrorInvalidValue;
    }
    SynthFftArgs a;
    a.mag = mag;
    a.phases = phases;
    a.wsyn = wsyn;
    a.fft_tw = fft_tw;
    a.out = out;
    a.T = T;
    a.F = F;
    a.hop = hop;
    a.overlap = overlap;
    a.rows = rows;
    a.teams = teams;
    a.n_tiles = (T + overlap - 1 + rows - 1) / rows;
    const size_t smem = pghi_synth_fft_smem_floats(rows, hop, n_fft, teams) * sizeof(float);
    cudaError_t err = pghi_allow_smem(pghi_synthesize_fft_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    pghi_synthesize_fft_kernel<<<dim3((unsigned)(B * a.n_tiles)), kThreads, smem,
                                 (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
