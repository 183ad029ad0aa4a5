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
//                              sessions _session_pghi_kernel (N) and
//                              _session_pghi_invert_kernel (Q); their analysis and
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
// Streaming (RT-PGHI): the same fill per frame with the causal time stencil
// (3 Y[t] - 4 Y[t-1] + Y[t-2]) / 2 and, per chunk of T_c frames, the chunk's
// own threshold tol * max over its (T_c, F) magnitudes.  One block walks one
// session's chunks in order; the previous frames' magnitudes, logarithms and
// time steps stay in registers across the chunk boundary (the carried
// mag_buffer of the chunked loop), and the phase carry is re-wrapped there as
// atan2(m sin phi, m cos phi) of the last frame, which is what the chunked
// loop carries (angle of the committed spectrum): the phases then stay within
// one chunk's growth (16 frames x 2 pi hop k / n_fft), where a float32 ulp is
// small, instead of growing over the whole session.  Seeded, the kernel
// starts from a carried history instead of two zero frames: the pghi_gl
// sessions (stream_step.cu) run it one chunk at a time, since each chunk's
// seed starts from the previous chunk's polished phases.
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
};

// Shared memory: 3 rows of n_pad floats (the current frame's logarithm,
// magnitude and frequency step), the warps' frame maxima and chunk maxima (2 x
// 32 floats), the scans' totals (2 x 32 Affine).
__host__ __device__ inline size_t rt_pghi_smem_bytes(int n_pad) {
    return sizeof(float) * (3 * (size_t)n_pad + 64) + 2 * 32 * sizeof(Affine);
}

template <int kBPT>
__global__ void __launch_bounds__(1024) rt_pghi_phases_kernel(RtPghiArgs p) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = blockDim.x >> 5;
    const int n_pad = blockDim.x * kBPT;
    const int T = p.T, F = p.F, T_c = p.T_c;

    float* sYc = smem;
    float* sM = sYc + n_pad;
    float* sFs = sM + n_pad;
    float* sWmax = sFs + n_pad;
    float* sCmax = sWmax + 32;
    Affine* tot_up = reinterpret_cast<Affine*>(sCmax + 32);
    Affine* tot_dn = tot_up + 32;

    const long long b = blockIdx.x;
    const float* mag = p.mag + (size_t)b * T * F;
    const float* ang = p.angles + (size_t)b * p.Ta * F;
    float* out = p.phases + (size_t)b * T * F;
    const float big = (float)(10 * F);
    const float y_zero = logf(kPghiEps);  // logarithm of a zero magnitude

    // per bin: the phase carry, and of the two frames before the current one
    // the magnitude (m1), the logarithms (y1, y2) and the time step (ts1); a
    // fresh session starts after two zero frames, whose time step is the
    // carrier term alone
    float phi[kBPT], m1[kBPT], y1[kBPT], y2[kBPT], ts1[kBPT];
#pragma unroll
    for (int j = 0; j < kBPT; ++j) {
        phi[j] = 0.0f;
        m1[j] = 0.0f;
        y1[j] = y_zero;
        y2[j] = y_zero;
        ts1[j] = __fmul_rn(p.carrier, (float)(tid * kBPT + j));
    }
    if (p.prev_mag != nullptr) {
        // seeded: the session's carried frames (the chunked loop's
        // mag_buffer / phase_buffer) take the place of the zero frames; the
        // previous frame's time step comes from its logarithms as any frame's
        const float* pm = p.prev_mag + (size_t)b * 2 * F;
        const float* pp = p.prev_phase + (size_t)b * F;
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            if (k < F) {
                m1[j] = __ldg(pm + F + k);
                y1[j] = logf(fmaxf(m1[j], kPghiEps));
                y2[j] = logf(fmaxf(__ldg(pm + k), kPghiEps));
                phi[j] = __ldg(pp + k);
                sYc[k] = y1[j];
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            if (k < F) {
                const int kd = k > 0 ? k - 1 : 0, ku = k < F - 1 ? k + 1 : F - 1;
                ts1[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(sYc[ku], sYc[kd]), 0.5f), p.inv_fmul),
                                   __fmul_rn(p.carrier, (float)k));
            }
        }
        __syncthreads();  // the first step writes sYc
    }
    float abstol = kPghiEps;

    for (int t = 0; t < T; ++t) {
        if (t % T_c == 0) {
            // the chunk's threshold: its maximum over (T_c, F)
            float cm = 0.0f;
            const float* cmag = mag + (size_t)t * F;
            for (int i = tid; i < T_c * F; i += blockDim.x) cm = fmaxf(cm, __ldg(cmag + i));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
            if (lane == 0) sCmax[warp] = cm;
            __syncthreads();
            float mx = 0.0f;
            for (int w = 0; w < n_warps; ++w) mx = fmaxf(mx, sCmax[w]);
            abstol = fmaxf(__fmul_rn(p.tol, mx), kPghiEps);
            if (t > 0) {
                // the carry the chunked loop hands over: the angle of the
                // committed spectrum's last frame
#pragma unroll
                for (int j = 0; j < kBPT; ++j) {
                    float sn, cs;
                    sincosf(phi[j], &sn, &cs);
                    phi[j] = atan2f(__fmul_rn(m1[j], sn), __fmul_rn(m1[j], cs));
                }
            }
        }

        float mc[kBPT], yc[kBPT], fs[kBPT], tsc[kBPT];
        float wmax = -1.0f;
#pragma unroll
        for (int j = 0; j < kBPT; ++j) {
            const int k = tid * kBPT + j;
            float v = 0.0f;
            if (k < F) {
                v = __ldg(mag + (size_t)t * F + k);
                wmax = fmaxf(wmax, v);
            }
            yc[j] = logf(fmaxf(v, kPghiEps));
            const float dydt = __fmul_rn(
                __fadd_rn(__fsub_rn(__fmul_rn(3.0f, yc[j]), __fmul_rn(4.0f, y1[j])), y2[j]), 0.5f);
            mc[j] = v;
            fs[j] = __fadd_rn(__fmul_rn(-p.fmul, dydt), kPiF);
            sYc[k] = yc[j];
            sM[k] = v;
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
            tsc[j] = 0.0f;
            up[j] = identity_map();
            dn[j] = identity_map();
            if (k < F) {
                const int kd = k > 0 ? k - 1 : 0, ku = k < F - 1 ? k + 1 : F - 1;
                const float ck = __fmul_rn(p.carrier, (float)k);
                tsc[j] = __fadd_rn(
                    __fmul_rn(__fmul_rn(__fsub_rn(sYc[ku], sYc[kd]), 0.5f), p.inv_fmul), ck);
                const float ct = __fmul_rn(__fadd_rn(ts1[j], tsc[j]), 0.5f);
                phit[j] = __fadd_rn(phi[j], ct);
                up[j].b = k == 0 ? 0.0f : __fmul_rn(__fadd_rn(fs[j], sFs[k - 1]), 0.5f);
                dn[j].b = k == F - 1 ? 0.0f : -__fmul_rn(__fadd_rn(fs[j], sFs[k + 1]), 0.5f);
                sig[j] = mc[j] > abstol;
                const float m_dn = k == 0 ? -1.0f : sM[k - 1];
                const float m_up = k == F - 1 ? -1.0f : sM[k + 1];
                anch[j] = sig[j] && m1[j] > abstol && mc[j] >= m_dn && mc[j] >= m_up;
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
                if (!sig[j]) v = __ldg(ang + (size_t)t * F + k);
                phi[j] = v;
                out[(size_t)t * F + k] = v;
            }
            y2[j] = y1[j];
            y1[j] = yc[j];
            m1[j] = mc[j];
            ts1[j] = tsc[j];
        }
        // the scans' barriers lie between this step's reads of the shared rows
        // and the next step's writes
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

long long att_rt_pghi_smem_bytes(int n_pad) {
    return (long long)att::rt_pghi_smem_bytes(n_pad);
}

// mag, phases: (B, T, F) float32 with T a multiple of T_c; angles (B, Ta, F),
// Ta >= T.  prev_mag (B, 2, F) and prev_phase (B, F) seed the session with a
// carried history (both or neither; null: a fresh session).  bpt bins per
// thread (1, 2 or 4) with ceil(F / (32 bpt)) warps per block, at most 32; one
// block per session.  Returns a cudaError_t.
int att_rt_pghi_phases(const float* mag, const float* angles, const float* prev_mag,
                       const float* prev_phase, float* phases, long long B, int T, int Ta, int F,
                       int T_c, float tol, float fmul, float inv_fmul, float carrier, int bpt,
                       void* stream) {
    using namespace att;
    if (B < 1 || T < 1 || F < 2 || T_c < 1 || T % T_c != 0 || Ta < T ||
        (prev_mag == nullptr) != (prev_phase == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_warps = (F + 32 * bpt - 1) / (32 * bpt);
    if (n_warps > 32 || (bpt != 1 && bpt != 2 && bpt != 4)) return (int)cudaErrorInvalidValue;
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
    const int threads = 32 * n_warps;
    const size_t smem = rt_pghi_smem_bytes(threads * bpt);
    dim3 grid((unsigned)B);
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_RT_PGHI(BPT)                                             \
    do {                                                                    \
        err = pghi_allow_smem(rt_pghi_phases_kernel<BPT>, smem);            \
        if (err != cudaSuccess) return (int)err;                            \
        rt_pghi_phases_kernel<BPT><<<grid, threads, smem, s>>>(a);          \
    } while (0)
    if (bpt == 1) ATT_LAUNCH_RT_PGHI(1);
    else if (bpt == 2) ATT_LAUNCH_RT_PGHI(2);
    else ATT_LAUNCH_RT_PGHI(4);
#undef ATT_LAUNCH_RT_PGHI
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
