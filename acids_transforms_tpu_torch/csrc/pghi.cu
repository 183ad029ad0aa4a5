// Phase Gradient Heap Integration, peak-anchored scan form, and the windowed
// inverse DFT with overlap-add, for Hopper (sm_90a).
//
// Replaces, from the JAX package's ops/pallas/pghi_kernel.py:
//   pghi_plan_kernel + pghi_walk_kernel
//                           <- _pghi_invert_kernel, recurrence part (emit_phases, bidir)
//   pghi_synthesize_fft_kernel, pghi_synthesize_kernel
//                           <- _pghi_invert_kernel, synthesis part (phases_in), with
//                              ops/pallas/ola.py:ola_accumulate: the FFT route
//                              (fft_smem.cuh:frames_irfft) where n_fft is a power of
//                              two from 64 to 4096, its mixed-radix instance where
//                              fft_covers_smooth(n_fft), its radix-7 instance where
//                              fft_covers_smooth7(n_fft) and n_fft has a factor 7,
//                              the product route elsewhere
// pghi_invert_fused is the recurrence followed by the synthesis.  And from
// ops/pallas/stream_step.py:
//   rt_pghi_phases_kernel   <- _rt_pghi_phases, the recurrence of the streaming
//                              sessions _session_pghi_kernel (N),
//                              _session_pghi_invert_kernel (Q) and the seed of
//                              _session_pghi_gl_kernel (O); their analysis and
//                              synthesis are kernels of stream_step.cu
//
// What bounds them on this card.  The recurrence as a function is bound by
// bytes (magnitudes read, phases written, the silent bins' angles read), but
// frame t needs frame t - 1, so a clip is one chain of T dependent steps and
// latency bounds whatever part of the work stays on that chain.  The
// synthesis on the FFT route does an inverse FFT's operations a frame; on the
// product route it keeps the product form of the kernel it replaces, 2F *
// n_fft multiply-adds per frame (1.05 M at n_fft 1024, 41 times the FFT's),
// so that route's own ceiling is the card's fp32 FMA rate.
//
// Design of the recurrences: the fill.  Almost nothing in a frame of the
// recurrence needs the previous frame's phases: the threshold, the
// logarithms, the gradients, the anchors (peak rule, or the onset rule in a
// frame without a peak anchor), each bin's nearest anchor on either side
// with the tie rule (below wins), and the segment sums of the frequency
// steps from an anchor come from magnitudes alone.  Only phi_{t-1}[anchor] + ct is carried.  So both
// recurrences plan each frame apart from the chain (pghi_plan_frame, one
// warp a frame: two segmented scans over 128-bin tiles, 4 bins a lane,
// Kogge-Stone over the lanes and the tiles' carry, a head restarting the
// sum) and walk the frames with a gather and an add or two a bin.  The
// segment sums are local (no cancellation between numbers of the phases'
// size).  Phases are not wrapped (that would be another result), so every
// addition is written with __fadd_rn and friends: the compiler may not
// contract or reorder them, and the plain PyTorch versions repeat them in
// the same order.  logf / sincosf are the full-range functions; this file
// must not be built with --use_fast_math.
//
// Offline (K's recurrence): two launches.  All frames and the clip's
// threshold are known at launch, so the plan needs no chain at all:
// pghi_plan_kernel runs it over every frame of every clip at once, a block a
// tile of up to 4 consecutive frames of one clip (their magnitudes and those
// of one halo frame on each side brought by one bulk copy, each logf taken
// once), a warp a frame for the frame's time stencil (central: (Y[t+1] -
// Y[t-1]) / 2, the edge replicated, the sign flipped on bidir's backward
// chain) and the fill's scans.  It writes per bin its source (int16, -1 for
// a constant) and one float, off = ct[src] + seg (the constant, the angle of
// a silent bin or 0 in a frame without an anchor, where src < 0), into a
// (B, T, Fp) plan, Fp = F rounded up to 8.  pghi_walk_kernel is the chain,
// one block a chain: phi_t[k] = phi_{t-1}[src] + off, one shared-memory
// gather and one add a bin, the two phase rows double-buffered in shared
// memory, one barrier a frame; side warps bring the plan's rows four frames
// a bulk copy into a ring of 16 (8 above 2232 bins), so no load on the chain
// waits on device memory, and write the finished rows out.  off is added
// once to the anchor's phase: one rounding at the phase's size (the kernel
// before this design added phi + ct at the leaf of a Kogge-Stone tree of
// affine maps, then the steps).  Measured on the card (PERF.md section 6):
// the walk takes about as long at 8 clips as at 128, so the latency of its
// steps bounds it, not bytes; the plan is bound by the issue of its passes
// (logarithms, stencil, scans, plan row) at 16 warps an SM.  Bulk copies of
// 4 rows, 4-frame tiles and the angles read only at the silent bins were
// each timed faster than the alternatives tried.
//
// bidir: the plan takes frames t >= T / 2 in the forward orientation
// (previous frame t - 1, next min(t + 1, T - 1), sign +1) and frames t < T /
// 2 in the backward one (previous t + 1, next max(t - 1, 0), sign -1); chain
// 0 walks mid .. T - 1, chain 1 first repeats chain 0's seed step at mid
// (the same plan row, unstored), so its carry is the seed phase without any
// exchange between blocks, then walks mid - 1 .. 0.  Causal: frame -1 is the
// zero frame.
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
// chunk's polished phases.  A session's frames are not all known at launch
// in a streaming call's shape (one block a session, a chunk's threshold
// known a stage ahead), so one block walks one session with two kinds of
// warps.  Producer warps plan a stage of frames (up to 16, within a chunk)
// at a time, all together: the next chunk's threshold a stage ahead (which
// also brings it into L2), the stage's angles by cp.async into a stage
// buffer, the logarithms and the bins' flags, ct and the frequency
// derivatives, each lanes on consecutive bins; then a frame a warp
// (pghi_plan_frame).  The chain warps walk the frames: phi_t[k] =
// (phi_{t-1}[src] + ct[src]) + seg[k], one gather from a shared-memory phase
// row, two adds and a store, and one barrier of the chain's warps a frame;
// they read nothing from device memory.  Two stage buffers (they fit with
// one frame up to 4096 bins) let the producers plan stage s + 1 while the
// chain walks stage s.  Measured on the card at 64 sessions x 688 frames x
// 513 bins (chip_smoke.py phase 5): the chain is hidden behind the
// producers, which bound the kernel; one buffer (no overlap) and stages of 8
// are slower, and a seeded 22-frame chunk is faster as two stages of 11 than
// as one of 22 (PERF.md section 6).  The plain version (ops/cuda/
// stream_step.py: rt_fill_plan, rt_pghi_phases_reference) repeats the order
// of every float32 operation.
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
// repeats it.  No basis.  Where fft_covers_smooth(n_fft) (even, 2^a 3^b
// 5^c, no power of two) the same kernel's kSmooth instance runs frames_irfft's
// mixed-radix stages (plain version: frames_irfft_reference(..., smooth=True)
// under irfft_window(..., smooth=True)), and where fft_covers_smooth7(n_fft)
// and n_fft has a factor 7 (896, 1344, 1568, ...) its kSeven instance, a
// radix-7 stage first.
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

// ---------------------------------------------------------------- the fill
constexpr int kFillE = 4;                 // bins a lane owns in a tile of the fill's scans
constexpr int kFillTile = 32 * kFillE;    // bins one warp's scan covers at a time
constexpr int kFillNone = 8192;           // "no anchor on this side" (more than any distance)
constexpr short kFillSig = 1, kFillAnchor = 2;  // a bin's flags in the source row while it is planned

// A row of F floats rounded up to 4 (16-byte aligned rows; 8 for int16 rows).
__host__ __device__ inline int pghi_row(int F) { return (F + 3) & ~3; }

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

__device__ __forceinline__ void load4(const float* p, float (&v)[kFillE]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// The time step at bin k from its neighbours' logarithms (ylo at k - 1, yhi
// at k + 1, clamped at the ends by the caller).
__device__ __forceinline__ float pghi_ts(float inv_fmul, float carrier, float ylo, float yhi, int k) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(yhi, ylo), 0.5f), inv_fmul), __fmul_rn(carrier, (float)k));
}

// The frequency derivative of the phase at a bin, RT-PGHI's causal time
// stencil: from the logarithms of its frame and the two before.
__device__ __forceinline__ float rt_fs(float fmul, float yc, float y1, float y2) {
    const float dydt = __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn(3.0f, yc), __fmul_rn(4.0f, y1)), y2), 0.5f);
    return __fadd_rn(__fmul_rn(-fmul, dydt), kPiF);
}

// The same, K's central time stencil from the previous and the next frame in
// walking order, the sign of the walking direction applied.
__device__ __forceinline__ float k_fs(float fmul, float sgn, float yp, float yn) {
    const float dydt = __fmul_rn(__fsub_rn(yn, yp), 0.5f);
    return __fadd_rn(__fmul_rn(sgn, __fmul_rn(-fmul, dydt)), kPiF);
}

// One frame's plan, by one warp, from shared rows of pghi_row(F) (both
// recurrences; rt_fill_plan / fill_sources in the plain versions, ops/cuda/
// stream_step.py and ops/cuda/pghi_kernel.py).  On entry fs_r holds the
// frame's frequency derivatives, src_r its bins' flags (sig | anchor << 1,
// by the peak rule), seg_r what a silent bin keeps; `any` says whether the
// peak rule found an anchor.  Writes the source bin (src_r) and the segment
// sum, or the constant, of every bin (seg_r).
//   A. without an anchor, the onset rule: every audible bin equal to the
//      frame maximum (mrow, the frame's magnitudes);
// then over the frame's 128-bin tiles, lane `lane` holding bins 128 i + 4
// lane .. + 3 (its neighbours' values through shuffles and the carries):
//   C. tiles upward: the step up (fs of the bin and the one below, into
//      fs_r), the segment sum from the nearest anchor below (into seg_r at
//      the audible bins; a silent bin keeps its value) and that anchor's bin
//      (packed into src_r with the flags);
//   D. tiles downward: the step down (minus the next bin's step up), the
//      segment sum from above, the source by the distance rule (a tie takes
//      the anchor below), the constant of a silent bin or of a frame without
//      an anchor (0, and source -1 for both).
__device__ __forceinline__ void pghi_plan_frame(const float* mrow, int any, float* fs_r, int F, short* src_r,
                                                float* seg_r, int lane) {
    const int nt = (F + kFillTile - 1) / kFillTile;
    const int row = pghi_row(F);

    // A.
    if (!any) {
        float fmax = -1.0f;
        for (int k = lane; k < F; k += 32) fmax = fmaxf(fmax, mrow[k]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) fmax = fmaxf(fmax, __shfl_xor_sync(0xffffffffu, fmax, o));
        for (int k = lane; k < F; k += 32) {
            const bool an = (src_r[k] & kFillSig) && mrow[k] == fmax;
            any |= an ? 1 : 0;
            if (an) src_r[k] = kFillSig | kFillAnchor;
        }
        any = __any_sync(0xffffffffu, any);
        __syncwarp();
    }

    // C.
    SegSum carry{0, 0.0f};
    int cbelow = -1;
    float fs_left = 0.0f;  // fs of the last bin of the tile below
    for (int i = 0; i < nt; ++i) {
        const int k0 = i * kFillTile + kFillE * lane;
        const bool act = k0 < row;
        float fs[kFillE] = {0.0f, 0.0f, 0.0f, 0.0f}, an4[kFillE] = {0.0f, 0.0f, 0.0f, 0.0f};
        short fl[kFillE] = {0, 0, 0, 0};
        if (act) {
            load4(fs_r + k0, fs);
            load4(seg_r + k0, an4);
            const short4 w = *reinterpret_cast<const short4*>(src_r + k0);
            fl[0] = w.x; fl[1] = w.y; fl[2] = w.z; fl[3] = w.w;
        }
        float below_fs = __shfl_up_sync(0xffffffffu, fs[kFillE - 1], 1);
        if (lane == 0) below_fs = fs_left;
        SegSum own[kFillE];
        float sup[kFillE];
        int bl[kFillE];
#pragma unroll
        for (int e = 0; e < kFillE; ++e) {
            const int k = k0 + e;
            const int an = (k < F && (fl[e] & kFillAnchor)) ? 1 : 0;
            const float fprev = e == 0 ? below_fs : fs[e - 1];
            sup[e] = (k == 0 || k >= F) ? 0.0f : __fmul_rn(__fadd_rn(fs[e], fprev), 0.5f);
            const SegSum x{an, an ? 0.0f : sup[e]};
            own[e] = e == 0 ? x : seg_compose(own[e - 1], x);
            bl[e] = an ? k : (e == 0 ? -1 : bl[e - 1]);
        }
        const SegSum incl = seg_warp_scan<true>(own[kFillE - 1], lane);
        const SegSum before = seg_compose(carry, seg_shift<true>(incl, 1, lane));
        int lmax = bl[kFillE - 1];
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, lmax, s);
            if (lane >= s) lmax = max(lmax, o);
        }
        int lex = __shfl_up_sync(0xffffffffu, lmax, 1);
        if (lane == 0) lex = -1;
        const int bfrom = max(cbelow, lex);
        if (act) {
            float su[kFillE];
            short w[kFillE];
#pragma unroll
            for (int e = 0; e < kFillE; ++e) {
                su[e] = (fl[e] & kFillSig) ? seg_compose(before, own[e]).b : an4[e];
                w[e] = (short)(fl[e] | ((max(bfrom, bl[e]) + 1) << 2));
            }
            *reinterpret_cast<float4*>(fs_r + k0) = make_float4(sup[0], sup[1], sup[2], sup[3]);
            *reinterpret_cast<float4*>(seg_r + k0) = make_float4(su[0], su[1], su[2], su[3]);
            *reinterpret_cast<short4*>(src_r + k0) = make_short4(w[0], w[1], w[2], w[3]);
        }
        carry = seg_compose(carry, seg_lane(incl, 31));
        cbelow = max(cbelow, __shfl_sync(0xffffffffu, lmax, 31));
        fs_left = __shfl_sync(0xffffffffu, fs[kFillE - 1], 31);
    }

    // D.
    carry = SegSum{0, 0.0f};
    int cabove = kFillNone;
    float sup_right = 0.0f;  // the step up of bin 0 of the tile above
    for (int i = nt - 1; i >= 0; --i) {
        const int k0 = i * kFillTile + kFillE * lane;
        const bool act = k0 < row;
        float sup[kFillE] = {0.0f, 0.0f, 0.0f, 0.0f}, sv[kFillE] = {0.0f, 0.0f, 0.0f, 0.0f};
        short w[kFillE] = {0, 0, 0, 0};
        if (act) {
            load4(fs_r + k0, sup);
            load4(seg_r + k0, sv);
            const short4 q = *reinterpret_cast<const short4*>(src_r + k0);
            w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
        }
        float sup_up = __shfl_down_sync(0xffffffffu, sup[0], 1);
        if (lane == 31) sup_up = sup_right;
        SegSum own[kFillE];
        int ab[kFillE];
#pragma unroll
        for (int e = kFillE - 1; e >= 0; --e) {
            const int k = k0 + e;
            const int an = (k < F && (w[e] & kFillAnchor)) ? 1 : 0;
            const float nb = e < kFillE - 1 ? sup[e + 1] : sup_up;
            const float sdn = k < F - 1 ? -nb : 0.0f;
            const SegSum x{an, an ? 0.0f : sdn};
            own[e] = e == kFillE - 1 ? x : seg_compose(own[e + 1], x);
            ab[e] = an ? k : (e == kFillE - 1 ? kFillNone : ab[e + 1]);
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
        if (lane == 31) lex = kFillNone;
        const int afrom = min(cabove, lex);
        if (act) {
            short sr[kFillE];
#pragma unroll
            for (int e = 0; e < kFillE; ++e) {
                const int k = k0 + e;
                sr[e] = -1;
                // a silent bin keeps its value; an audible one holds the sum from below
                if (k < F && (w[e] & kFillSig)) {
                    if (w[e] & kFillAnchor) {
                        sr[e] = (short)k;
                        sv[e] = -0.0f;
                    } else if (!any) {
                        sv[e] = 0.0f;
                    } else {
                        const int below = (w[e] >> 2) - 1;
                        const int above = min(afrom, ab[e]);
                        const int du = below >= 0 ? k - below : kFillNone;
                        const int dd = above < kFillNone ? above - k : kFillNone;
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Bulk copies by the tensor memory accelerator, completion on an mbarrier
// in shared memory (16-byte aligned addresses, sizes a multiple of 16).
__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival of the barrier's phase, announcing `bytes` to come.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed; trap
// after about 10 s rather than hang.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    const unsigned a = smem_addr(bar);
    const long long t0 = clock64();
    unsigned done = 0;
    while (true) {
        asm volatile(
            "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
        if (done) return;
        if (clock64() - t0 > (1ll << 34)) __trap();
    }
}

// The span [p, p + n floats) widened to 16-byte boundaries for a bulk copy:
// the aligned start, the floats before p in it and its bytes.
struct Span16 {
    const char* from;
    int shift;
    unsigned bytes;
};
__device__ __forceinline__ Span16 span16(const float* p, long long n) {
    const unsigned long long a = (unsigned long long)p;
    const unsigned long long a0 = a & ~15ull;
    const unsigned long long e = (a + 4ull * (unsigned long long)n + 15ull) & ~15ull;
    return Span16{reinterpret_cast<const char*>(a0), (int)((a - a0) / 4), (unsigned)(e - a0)};
}

// ------------------------------------------------- K's offline recurrence
constexpr int kPlanTile = 4;    // frames a plan block takes, at most (a warp a frame)
constexpr int kWalkQuads = 2;   // groups of 4 bins a walk chain thread owns, at most
constexpr int kWalkWarps = 16;  // chain warps of a walk block, at most
constexpr int kWalkSide = 2;    // side warps of a walk block: the copies and the stores
constexpr int kWalkGroup = 4;   // plan rows a bulk copy of the walk brings, at most

// The plan's rows: F rounded up to 8, so that both arrays' rows are whole
// 16-byte units for the walk's bulk copies.
__host__ __device__ inline int pghi_plan_row(int F) { return (F + 7) & ~7; }

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~(size_t)15; }

struct PlanArgs {
    const float* mag;     // (B, T, F)
    const float* angles;  // (B, T, F) phases of the silent bins
    const float* abstol;  // (B,)
    short* src;           // (B, T, Fp) out: the source bin, or -1
    float* off;           // (B, T, Fp) out: ct[src] + the segment sum, or the constant
    int T, F, Fp, bidir, tile, n_tiles;
    float fmul;           // gamma / (hop n_fft)
    float inv_fmul;       // 1 / fmul: the time step multiplies by it
    float carrier;        // 2 pi hop / n_fft
};

// Shared memory of a plan block, in this order: the magnitudes and the
// logarithms of the tile's frames and one halo frame on each side (2 x
// (tile + 2) float rows of pghi_row(F)); a work area, per frame an fs and a
// segment-sum float row and an int16 source row (at least the bulk copy of
// the halo's magnitudes, which it holds first); the mbarrier.
__host__ __device__ inline size_t pghi_plan_work_bytes(int F, int tile) {
    const size_t row = (size_t)pghi_row(F);
    const size_t work = (size_t)tile * row * (2 * sizeof(float) + sizeof(short));
    const size_t stage = round16(sizeof(float) * (size_t)(tile + 2) * F + 32);
    return round16(work > stage ? work : stage);
}
__host__ __device__ inline size_t pghi_plan_smem_bytes(int F, int tile) {
    return 2 * sizeof(float) * (size_t)(tile + 2) * pghi_row(F) + pghi_plan_work_bytes(F, tile) + 16;
}

// A block plans frames t0 .. t0 + tile - 1 of clip b.  One thread copies the
// magnitudes of frames t0 - 1 .. t0 + tile that lie in the clip, as one span,
// by a bulk copy; all threads then fill
// the magnitude and logarithm rows (zeros and log(eps) outside the clip:
// frame -1 is the causal zero frame, frames from T on are never read), each
// logf taken once.  Warp q then plans frame t0 + q alone: in its walking
// orientation, the frequency derivative and the flags by the peak rule with
// the previous frame in walking order; pghi_plan_frame (skipped in a frame
// without an audible bin: all angles); and the plan row: (src, ct[src] +
// seg) at an audible bin with a source (ct from the logarithms at the
// source, as the kernel before this design took it at every bin), (-1, 0)
// at an audible bin of a frame without an anchor, (-1, its angle) at a
// silent bin, (-1, 0) at the padding.
__global__ void __launch_bounds__(32 * kPlanTile) pghi_plan_kernel(PlanArgs p) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_thr = blockDim.x;
    const int T = p.T, F = p.F, TT = p.tile, R = TT + 2;
    const int row = pghi_row(F);
    float* sM = smem;                        // R rows: magnitudes of frames t0 - 1 ..
    float* sY = sM + (size_t)R * row;        // R rows: their logarithms
    char* work = reinterpret_cast<char*>(sY + (size_t)R * row);
    float* sFs = reinterpret_cast<float*>(work);            // TT rows: fs, then the step up
    float* sSeg = sFs + (size_t)TT * row;                   // TT rows: the segment sums
    short* sSrc = reinterpret_cast<short*>(sSeg + (size_t)TT * row);  // TT rows: flags, then sources
    const float* stage = reinterpret_cast<const float*>(work);        // the halo's bulk copy, first
    const size_t work_bytes = pghi_plan_work_bytes(F, TT);
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(work + work_bytes);

    const long long blk = blockIdx.x;
    const long long b = blk / p.n_tiles;
    const int t0 = (int)(blk - b * p.n_tiles) * TT;
    const int f_lo = t0 - 1;
    const int f0 = max(f_lo, 0), f1 = min(f_lo + R, T);   // the halo's frames in the clip
    const float* mag = p.mag + (size_t)b * T * F;
    const Span16 hm = span16(mag + (size_t)f0 * F, (long long)(f1 - f0) * F);
    if (tid == 0) {
        mbar_init(bar);
        mbar_expect(bar, hm.bytes);
        bulk_load(work, hm.from, hm.bytes, bar);
    }
    __syncthreads();
    mbar_wait(bar, 0);
    for (int r = 0; r < R; ++r) {
        const int f = f_lo + r;
        const bool in = f >= f0 && f < f1;
        const float* m = stage + hm.shift + (long long)(f - f0) * F;
        for (int k = tid; k < F; k += n_thr) {
            const float v = in ? m[k] : 0.0f;
            sM[(size_t)r * row + k] = v;
            sY[(size_t)r * row + k] = logf(fmaxf(v, kPghiEps));
        }
    }
    __syncthreads();  // the work area is free again

    const int t = t0 + warp;
    if (warp >= TT || t >= T) return;
    // the walking orientation: forward, or backward on bidir's chain 1
    const bool fwd = !p.bidir || t >= T / 2;
    const int fp = fwd ? t - 1 : t + 1;
    const int fn = fwd ? min(t + 1, T - 1) : max(t - 1, 0);
    const float sgn = fwd ? 1.0f : -1.0f;
    const float abstol = p.abstol[b];
    const float* mp_r = sM + (size_t)(fp - f_lo) * row;
    const float* mc_r = sM + (size_t)(t - f_lo) * row;
    const float* yp_r = sY + (size_t)(fp - f_lo) * row;
    const float* yc_r = sY + (size_t)(t - f_lo) * row;
    const float* yn_r = sY + (size_t)(fn - f_lo) * row;
    float* fs_r = sFs + (size_t)warp * row;
    float* seg_r = sSeg + (size_t)warp * row;
    short* src_r = sSrc + (size_t)warp * row;
    int any = 0, audible = 0;
    for (int k0 = lane; k0 < F; k0 += 4 * 32) {
        float yp[4], yn[4], mc[4], mp[4], mdn[4], mup[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int k = min(k0 + 32 * u, F - 1);
            yp[u] = yp_r[k];
            yn[u] = yn_r[k];
            mc[u] = mc_r[k];
            mp[u] = mp_r[k];
            mdn[u] = k > 0 ? mc_r[k - 1] : -1.0f;
            mup[u] = k < F - 1 ? mc_r[k + 1] : -1.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int k = k0 + 32 * u;
            if (k < F) {
                fs_r[k] = k_fs(p.fmul, sgn, yp[u], yn[u]);
                const bool sg = mc[u] > abstol;
                const bool an = sg && mp[u] > abstol && mc[u] >= mdn[u] && mc[u] >= mup[u];
                any |= an ? 1 : 0;
                audible |= sg ? 1 : 0;
                src_r[k] = (short)((sg ? kFillSig : 0) | (an ? kFillAnchor : 0));
                seg_r[k] = 0.0f;
            }
        }
    }
    any = __any_sync(0xffffffffu, any);
    audible = __any_sync(0xffffffffu, audible);
    __syncwarp();
    if (audible) pghi_plan_frame(mc_r, any, fs_r, F, src_r, seg_r, lane);
    __syncwarp();

    const size_t o = ((size_t)b * T + t) * p.Fp;
    short* so = p.src + o;
    float* oo = p.off + o;
    const float* ang = p.angles + ((size_t)b * T + t) * F;
    for (int k0 = kFillE * lane; k0 < p.Fp; k0 += kFillTile) {
        short s4[kFillE] = {-1, -1, -1, -1};
        float o4[kFillE] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k0 < F) {
#pragma unroll
            for (int e = 0; e < kFillE; ++e) {
                const int k = k0 + e;
                if (k < F) {
                    if (!(mc_r[k] > abstol)) {
                        o4[e] = __ldg(ang + k);
                    } else {
                        const int s = src_r[k];
                        s4[e] = (short)s;
                        o4[e] = seg_r[k];
                        if (s >= 0) {
                            // ct at the source, from its neighbours' logarithms
                            const int sd = s > 0 ? s - 1 : 0, su = s < F - 1 ? s + 1 : F - 1;
                            const float tsp = pghi_ts(p.inv_fmul, p.carrier, yp_r[sd], yp_r[su], s);
                            const float tsc = pghi_ts(p.inv_fmul, p.carrier, yc_r[sd], yc_r[su], s);
                            const float ct = __fmul_rn(sgn, __fmul_rn(__fadd_rn(tsp, tsc), 0.5f));
                            o4[e] = __fadd_rn(ct, seg_r[k]);
                        }
                    }
                }
            }
        }
        *reinterpret_cast<short4*>(so + k0) = make_short4(s4[0], s4[1], s4[2], s4[3]);
        *reinterpret_cast<float4*>(oo + k0) = make_float4(o4[0], o4[1], o4[2], o4[3]);
    }
}

struct WalkArgs {
    const short* src;  // (B, T, Fp)
    const float* off;  // (B, T, Fp)
    float* phases;     // (B, T, F) out
    int T, F, Fp, bidir;
};

// Shared memory of a walk block: the two phase rows, then kSlots ring slots
// of kWalkGroup plan rows each (a float and an int16 a bin), all of Fp, and
// an mbarrier a slot.
__host__ __device__ inline size_t pghi_walk_smem_bytes(int F, int slots) {
    return (size_t)pghi_plan_row(F) *
               (2 * sizeof(float) + (size_t)slots * kWalkGroup * (sizeof(float) + sizeof(short))) +
           8 * (size_t)slots;
}

// One block walks one chain: chain warps, then kWalkSide side warps.  The
// side warps' first lane keeps the plan rows of the next kSlots - 1 groups
// of kWalkGroup steps in flight: a group's frames are consecutive in the
// plan (descending on bidir's chain 1), so one bulk copy brings its source
// rows and one its offset rows into a ring slot, completing on the slot's
// mbarrier.  At step s the side warps also write the phase row of step s -
// 1 (complete since the last barrier) to `phases`, lanes on consecutive
// bins.  Chain thread i owns the bin quads i, i + n_chain, ... (at most
// kWalkQuads): at step s it gathers from the previous phase row, adds,
// stores its quads of the new row to shared memory, and reads step s + 1's
// quads into registers (waiting for the slot where that step starts a
// group).  The phase rows alternate, so one barrier of the whole block a
// step separates the step's reads from the next step's writes, lets the
// side warps read a row before the chain writes over it, and lets the
// copying lane refill, as a group starts, the slot of the group before it,
// which every chain thread has read before that barrier.
template <int kSlots>
__global__ void __launch_bounds__(32 * (kWalkWarps + kWalkSide)) pghi_walk_kernel(WalkArgs p) {
    extern __shared__ __align__(16) float smem[];
    constexpr int G = kWalkGroup;
    const int tid = threadIdx.x;
    const int n_chain = blockDim.x - 32 * kWalkSide;
    const int T = p.T, F = p.F, Fp = p.Fp;
    float* sPhi = smem;                                                      // 2 x Fp
    float* sOff = sPhi + 2 * Fp;                                             // kSlots x G x Fp
    short* sSrc = reinterpret_cast<short*>(sOff + kSlots * G * Fp);          // kSlots x G x Fp
    unsigned long long* sBar = reinterpret_cast<unsigned long long*>(sSrc + kSlots * G * Fp);

    const int chain = p.bidir ? (int)(blockIdx.x & 1) : 0;
    const long long b = p.bidir ? (long long)(blockIdx.x >> 1) : (long long)blockIdx.x;
    const int mid = T / 2;
    const int n_steps = !p.bidir ? T : (chain == 0 ? T - mid : mid + 1);
    const bool down = p.bidir && chain == 1;  // chain 1 walks mid, mid - 1, .. 0
    const int first = !p.bidir ? 0 : mid;     // the frame of step 0; step s's is first -+ s
    auto stored = [&](int s) { return !p.bidir || chain == 0 || s > 0; };
    // the steps of group g, and where step s lies in its slot
    auto group_steps = [&](int g) { return min(G, n_steps - g * G); };
    auto row_in_slot = [&](int s) {
        const int g = s / G;
        return down ? group_steps(g) - 1 - (s - g * G) : s - g * G;
    };

    if (tid == 0) {
        for (int i = 0; i < kSlots; ++i) mbar_init(sBar + i);
    }
    for (int k = tid; k < Fp; k += blockDim.x) sPhi[k] = 0.0f;
    __syncthreads();

    const int n_groups = (n_steps + G - 1) / G;
    if (tid >= n_chain) {
        // ---- the side warps
        const int sid = tid - n_chain, n_side = 32 * kWalkSide;
        const short* src = p.src + (size_t)b * T * Fp;
        const float* off = p.off + (size_t)b * T * Fp;
        auto issue = [&](int g) {
            if (g < n_groups) {
                const int c = group_steps(g);
                const int f0 = down ? first - g * G - (c - 1) : first + g * G;  // the lowest frame
                const int slot = g % kSlots;
                mbar_expect(sBar + slot, 6u * c * Fp);
                bulk_load(sSrc + slot * G * Fp, src + (size_t)f0 * Fp, 2u * c * Fp, sBar + slot);
                bulk_load(sOff + slot * G * Fp, off + (size_t)f0 * Fp, 4u * c * Fp, sBar + slot);
            }
        };
        // the phase row of step s (in the buffer the chain wrote it to) to `phases`
        auto emit = [&](int s) {
            if (stored(s)) {
                const float* r = sPhi + ((s & 1) ? 0 : Fp);
                float* o = p.phases + ((size_t)b * T + (down ? first - s : first + s)) * F;
                for (int k = sid; k < F; k += n_side) o[k] = r[k];
            }
        };
        if (sid == 0) {
            for (int g = 0; g < kSlots - 1; ++g) issue(g);
        }
        for (int s = 0; s < n_steps; ++s) {
            // as group g starts, into the slot of group g - 1
            if (sid == 0 && s % G == 0) issue(s / G + kSlots - 1);
            if (s > 0) emit(s - 1);
            __syncthreads();
        }
        emit(n_steps - 1);
        return;
    }

    // ---- the chain
    const int n_quads = Fp / 4;
    short4 rs[kWalkQuads];
    float4 ro[kWalkQuads];
    // this thread's quads of step s's plan rows, waiting for the slot where
    // the step starts a group
    auto fetch = [&](int s) {
        const int g = s / G;
        const int slot = g % kSlots;
        if (s - g * G == 0) mbar_wait(sBar + slot, (unsigned)(g / kSlots) & 1u);
        const int at = (slot * G + row_in_slot(s)) * Fp;
        const short4* sr = reinterpret_cast<const short4*>(sSrc + at);
        const float4* so = reinterpret_cast<const float4*>(sOff + at);
#pragma unroll
        for (int j = 0; j < kWalkQuads; ++j) {
            const int q = tid + j * n_chain;
            if (q < n_quads) {
                rs[j] = sr[q];
                ro[j] = so[q];
            }
        }
    };
    fetch(0);
    float* cur = sPhi;
    float* nxt = sPhi + Fp;
    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
        for (int j = 0; j < kWalkQuads; ++j) {
            const int q = tid + j * n_chain;
            if (q < n_quads) {
                float4 v;
                v.x = rs[j].x >= 0 ? __fadd_rn(cur[rs[j].x], ro[j].x) : ro[j].x;
                v.y = rs[j].y >= 0 ? __fadd_rn(cur[rs[j].y], ro[j].y) : ro[j].y;
                v.z = rs[j].z >= 0 ? __fadd_rn(cur[rs[j].z], ro[j].z) : ro[j].z;
                v.w = rs[j].w >= 0 ? __fadd_rn(cur[rs[j].w], ro[j].w) : ro[j].w;
                reinterpret_cast<float4*>(nxt)[q] = v;
            }
        }
        if (s + 1 < n_steps) fetch(s + 1);
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }
}

// ------------------------------------------------------ RT-PGHI (streaming)
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

constexpr int kRtWarps = 24;          // warps of the block, at most
constexpr int kRtStage = 16;          // frames a stage, at most (each has an anchor flag word)
constexpr int kRtBufs = 2;            // stage buffers
constexpr int kRtBatch = 8;           // bins a chain thread takes at once
// named barriers (0 is __syncthreads, which this kernel does not use)
constexpr int kBarProd = 1, kBarChain = 2, kBarFull = 3, kBarFree = 5;

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

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
    const size_t row = (size_t)pghi_row(F);
    return sizeof(float) * ((size_t)(S + 4) * row + 64) +
           (size_t)kRtBufs * row * ((size_t)S * (2 * sizeof(float) + sizeof(short)) + sizeof(float));
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
    const int row = pghi_row(F);
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
                            fq[k] = (short)((sg ? kFillSig : 0) | (an ? kFillAnchor : 0));
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
                    ctq[k] = __fmul_rn(__fadd_rn(pghi_ts(p.inv_fmul, p.carrier, y1[kd], y1[ku], k), pghi_ts(p.inv_fmul, p.carrier, yc[kd], yc[ku], k)), 0.5f);
                }
            }
            bar_sync(kBarProd, n_prod);
            // fs of frame s0 + q in place of the logarithms of frame s0 + q - 2,
            // each bin by one thread in order of q; the last two rows stay
            for (int k = tid; k < F; k += n_prod) {
                for (int q = 0; q < Sg; ++q) {
                    float* y = sY + (size_t)q * row + k;
                    *y = rt_fs(p.fmul, y[2 * row], y[row], y[0]);
                }
            }
            bar_sync(kBarProd, n_prod);
            for (int q = warp; q < Sg; q += p.P) {
                pghi_plan_frame(mag + (size_t)(s0 + q) * F, sAny[q], sY + (size_t)q * row, F,
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

// The samples of `rows` chunks, then frames_rfft's area (that of the route n
// takes), whose window slot holds wsyn.
__host__ __device__ inline size_t pghi_synth_fft_smem_floats(int rows, int hop, int n, int teams) {
    return (size_t)rows * hop + fft_area_floats(n, teams);
}

// K's synthesis on the FFT route: a block owns one clip and the output chunks
// c0 .. c0 + rows - 1 (c0 and rows multiples of 2 overlap).  frames_irfft
// runs the frames c0 - 2 overlap .. c0 + rows - 1 with pair stride overlap:
// local frame r is frame c0 - 2 overlap + r, so the block's pairs are the
// clip's (f, f + overlap) for f mod 2 overlap < overlap; the first group's
// first frames, and frames outside [0, T), are synthesized or loaded as zeros
// but add nothing.  Each sample collects its frames in class order f mod
// overlap.  kSmooth: the mixed-radix instance (fft_covers_smooth(n_fft):
// frames_irfft's mixed-radix stages, twiddles j < fft_smooth_table(n), wsyn
// with the 1 / n fold rounded once from float64; plan
// pghi_kernel._synth_fft_plan), the decode's smooth route with the pairs
// counted from frame c0 - 2 overlap; with kSeven its radix-7 instance
// (fft_covers_smooth7(n_fft), n_fft with a factor 7: 896 = 7 4 4 4 2),
// carve_fft / fft_stage / frames_irfft all told so.
template <bool kSmooth, bool kSeven = false>
__global__ void __launch_bounds__(kThreads, 2) pghi_synthesize_fft_kernel(SynthFftArgs a) {
    extern __shared__ __align__(16) float smem[];
    const int R = a.rows, T = a.T, F = a.F, hop = a.hop, ov = a.overlap;
    const int n = ov * hop;
    float* samples = smem;  // [R][hop]
    const FftSmem fs = carve_fft<kSmooth, kSeven>(samples + (size_t)R * hop, n);
    const long long blk = blockIdx.x;
    const long long b = blk / a.n_tiles;
    const int c0 = (int)(blk - b * a.n_tiles) * R;
    const int n_chunks = T + ov - 1;
    const size_t bofs = (size_t)b * T * F;
    fft_stage<kSmooth, kSeven>(a.wsyn, a.fft_tw, fs, n);  // wsyn in the window's slot
    for (int i = threadIdx.x; i < R * hop; i += kThreads) samples[i] = 0.0f;
    const int f0 = c0 - 2 * ov;
    // frames_irfft starts with a barrier and ends with one
    frames_irfft<kSmooth, kSeven>(
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

long long att_pghi_plan_smem_bytes(int F, int tile) { return (long long)att::pghi_plan_smem_bytes(F, tile); }

long long att_pghi_walk_smem_bytes(int F, int slots) { return (long long)att::pghi_walk_smem_bytes(F, slots); }

// K's plan: mag, angles: (B, T, F) float32, 2 <= F <= 4096; abstol: (B,);
// src (int16), off (float32): (B, T, Fp), Fp = F rounded up to 8, every
// value written.  tile frames a block (1 to 4; one warp each).  bidir plans
// the frames before T / 2 backward and needs T >= 4.  Returns a cudaError_t.
int att_pghi_plan(const float* mag, const float* angles, const float* abstol, short* src, float* off,
                  long long B, int T, int F, float fmul, float inv_fmul, float carrier, int bidir, int tile,
                  void* stream) {
    using namespace att;
    if (B < 1 || T < 1 || F < 2 || F > 4096 || (bidir && T < 4) || tile < 1 || tile > kPlanTile) {
        return (int)cudaErrorInvalidValue;
    }
    PlanArgs a;
    a.mag = mag;
    a.angles = angles;
    a.abstol = abstol;
    a.src = src;
    a.off = off;
    a.T = T;
    a.F = F;
    a.Fp = pghi_plan_row(F);
    a.bidir = bidir;
    a.tile = tile;
    a.n_tiles = (T + tile - 1) / tile;
    a.fmul = fmul;
    a.inv_fmul = inv_fmul;
    a.carrier = carrier;
    const size_t smem = pghi_plan_smem_bytes(F, tile);
    cudaError_t err = pghi_allow_smem(pghi_plan_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    pghi_plan_kernel<<<dim3((unsigned)(B * a.n_tiles)), 32 * tile, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// K's walk: src, off: (B, T, Fp) from att_pghi_plan, 16-byte aligned;
// phases: (B, T, F) out.  warps: chain warps (1 to 16) such that 32 warps x
// 2 quads of bins cover Fp, and two side warps besides; slots 2 or 4
// ring slots of 4 plan rows (8 or 16 rows in flight).  bidir runs two blocks
// a clip and needs T >= 4.  Returns a cudaError_t.
int att_pghi_walk(const short* src, const float* off, float* phases, long long B, int T, int F, int bidir,
                  int warps, int slots, void* stream) {
    using namespace att;
    const int Fp = pghi_plan_row(F);
    if (B < 1 || T < 1 || F < 2 || F > 4096 || (bidir && T < 4) || warps < 1 || warps > kWalkWarps ||
        32 * warps * 4 * kWalkQuads < Fp || (slots != 2 && slots != 4) || ((unsigned long long)src & 15) != 0 ||
        ((unsigned long long)off & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    WalkArgs a;
    a.src = src;
    a.off = off;
    a.phases = phases;
    a.T = T;
    a.F = F;
    a.Fp = Fp;
    a.bidir = bidir;
    const size_t smem = pghi_walk_smem_bytes(F, slots);
    const dim3 grid((unsigned)(bidir ? 2 * B : B));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (slots == 4) {
        err = pghi_allow_smem(pghi_walk_kernel<4>, smem);
        if (err != cudaSuccess) return (int)err;
        pghi_walk_kernel<4><<<grid, 32 * (warps + kWalkSide), smem, s>>>(a);
    } else {
        err = pghi_allow_smem(pghi_walk_kernel<2>, smem);
        if (err != cudaSuccess) return (int)err;
        pghi_walk_kernel<2><<<grid, 32 * (warps + kWalkSide), smem, s>>>(a);
    }
    return (int)cudaGetLastError();
}

// K's recurrence, the plan then the walk on the caller's stream: mag,
// angles, phases: (B, T, F) float32; abstol: (B,); src, off: the plan's
// (B, T, Fp) scratch.  Returns a cudaError_t.
int att_pghi_phases(const float* mag, const float* angles, const float* abstol, float* phases, short* src,
                    float* off, long long B, int T, int F, float fmul, float inv_fmul, float carrier, int bidir,
                    int tile, int warps, int slots, void* stream) {
    const int err = att_pghi_plan(mag, angles, abstol, src, off, B, T, F, fmul, inv_fmul, carrier, bidir, tile,
                                  stream);
    if (err != 0) return err;
    return att_pghi_walk(src, off, phases, B, T, F, bidir, warps, slots, stream);
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
// n_fft / 2 + 1, n_fft = overlap * hop a power of two from 64 to 4096 (1 <=
// teams <= 4096 / n_fft FFTs side by side), or on the smooth route where
// fft_covers_smooth7(n_fft) (1 <= teams <= fft_smooth_max_teams(n_fft); the
// radix-7 instance where n_fft has a factor 7); wsyn
// (n_fft,) the synthesis window / n_fft (frames_fft.irfft_window); fft_tw (2,
// n_fft) = (cos, -sin)(2 pi j / n_fft); out: (B, (T + overlap - 1) * hop),
// every sample written.  rows output chunks per block, a multiple of 2
// overlap.  Returns a cudaError_t.
int att_pghi_synthesize_fft(const float* mag, const float* phases, const float* wsyn,
                            const float* fft_tw, float* out, long long B, int T, int F, int hop,
                            int overlap, int rows, int teams, void* stream) {
    using namespace att;
    const int n_fft = overlap * hop;
    const bool smooth = !fft_covers(n_fft);
    const bool seven = smooth && n_fft % 7 == 0;
    const int max_teams = smooth ? fft_smooth_max_teams(n_fft) : fft_max_teams(n_fft);
    if (B < 1 || T < 1 || overlap < 2 || (smooth && !fft_covers_smooth7(n_fft)) || F != n_fft / 2 + 1 ||
        rows < 1 || rows % (2 * overlap) != 0 || teams < 1 || teams > max_teams) {
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
    const dim3 grid((unsigned)(B * a.n_tiles));
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
#define ATT_LAUNCH_SYNF(SMOOTH, SEVEN)                                                    \
    do {                                                                                  \
        err = pghi_allow_smem(pghi_synthesize_fft_kernel<SMOOTH, SEVEN>, smem);           \
        if (err != cudaSuccess) return (int)err;                                          \
        pghi_synthesize_fft_kernel<SMOOTH, SEVEN><<<grid, kThreads, smem, s>>>(a);        \
    } while (0)
    if (seven) ATT_LAUNCH_SYNF(true, true);
    else if (smooth) ATT_LAUNCH_SYNF(true, false);
    else ATT_LAUNCH_SYNF(false, false);
#undef ATT_LAUNCH_SYNF
    return (int)cudaGetLastError();
}

}  // extern "C"
