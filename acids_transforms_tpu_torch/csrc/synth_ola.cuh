// Windowed inverse DFT with the overlap-add folded into the product (sm_90a).
//
// Output chunk j (samples [j hop, (j + 1) hop) of the un-normalized overlap-add
// signal) collects the `overlap` frames that cover it,
//
//   out[j, n] = sum_{i < overlap} sum_{k2 < 2F} S[j - i, k2] * Bw[i, k2, n]
//
// with S[t] = [re | im] of frame t (zero outside [0, T)) and Bw the inverse
// real-DFT basis with the synthesis window folded in, cut into `overlap`
// pieces of hop samples: Bw[i, k2, n] = w[i hop + n] * (A | B)[k2, i hop + n].
// That is one product with contraction length overlap * 2F whose left operand
// re-reads the same frames at shifted rows, so the overlap-add happens in the
// accumulators: no atomics, no second pass, every output sample is written
// once by one thread in a fixed order.
//
// A block of 256 threads owns R = 8 * kRPT output chunks: warp ty owns kRPT of
// them, lane tx owns 8 sample columns (two float4) of a 256-column pass over
// the hop.  The frames' [re | im] rows lie in shared memory (row stride Kp,
// the contraction per piece padded to a multiple of 32 with zeros); the basis
// is staged through shared memory 32 rows at a time, the next chunk's values
// loaded into registers before the current chunk is multiplied.
//
// kFold > 0 sums the contraction in partial sums of kFold staged chunks
// (kFold * 32 terms, a piece's last one shorter), each added to the total when
// it ends: one running sum over overlap * Kp terms (4224 at n_fft 1024) of
// large values that cancel to a small sample rounds further from exact (see
// stream_step.cu, whose kernels take it).  kFold = 0 keeps the single running
// sum.
#pragma once

#include <cuda_runtime.h>

namespace att {

constexpr int kSynThreads = 256;
constexpr int kSynCols = 256;   // sample columns per pass
constexpr int kSynKC = 32;      // contraction rows staged at a time

__device__ __forceinline__ void fma8(float (&s)[8], float av, const float4& b0, const float4& b1) {
    s[0] = fmaf(av, b0.x, s[0]);
    s[1] = fmaf(av, b0.y, s[1]);
    s[2] = fmaf(av, b0.z, s[2]);
    s[3] = fmaf(av, b0.w, s[3]);
    s[4] = fmaf(av, b1.x, s[4]);
    s[5] = fmaf(av, b1.y, s[5]);
    s[6] = fmaf(av, b1.z, s[6]);
    s[7] = fmaf(av, b1.w, s[7]);
}

// S: (R + overlap - 1) rows of Kp floats in shared memory, row q = frame
// j0 - (overlap - 1) + q, or only the rows up to the last chunk's when
// n_chunks - j0 < R.  Bst: kSynKC * kSynCols floats of shared memory.
// basis: (overlap, Kp, hop) in device memory.  out_row: the clip's signal,
// n_chunks * hop floats; chunks [j0, j0 + R) below n_chunks are written.
//
// A slab (k_len > 0): S holds only the contraction columns k_begin ..
// k_begin + k_len - 1 of each frame's row (row stride k_len, a multiple of
// kSynKC), the product runs over those, and with `accumulate` the sums are
// added to out_row instead of stored: a caller whose frames' rows do not fit
// shared memory whole runs the slabs in turn.
template <int kRPT, int kFold = 0>
__device__ void synth_ola_tile(const float* S, float* Bst, const float* __restrict__ basis,
                               int Kp, int hop, int overlap, int j0, int n_chunks,
                               float* __restrict__ out_row, int k_begin = 0, int k_len = 0,
                               bool accumulate = false) {
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    constexpr int kVec = kSynKC * kSynCols / 4 / kSynThreads;  // float4 a thread stages
    const int Ks = k_len > 0 ? k_len : Kp;  // contraction columns of S per piece, its row stride
    // a thread's output chunks past the block's last one (n_chunks - j0) read
    // that chunk's frames instead: their sums are never stored, and S need
    // hold no rows beyond the last chunk's
    int rofs[kRPT];
    {
        const int last = max(0, min(8 * kRPT, n_chunks - j0) - 1);
#pragma unroll
        for (int r = 0; r < kRPT; ++r) rofs[r] = min(ty * kRPT + r, last) * Ks;
    }
    for (int c0 = 0; c0 < hop; c0 += kSynCols) {
        float acc[kRPT][8];
        float part[kFold > 0 ? kRPT : 1][8];  // the current partial sum (kFold > 0)
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
        }
#pragma unroll
        for (int r = 0; r < (kFold > 0 ? kRPT : 1); ++r) {
#pragma unroll
            for (int q = 0; q < 8; ++q) part[r][q] = 0.0f;
        }
        float4 stage[kVec];
        const int n_steps = overlap * (Ks / kSynKC);
        auto fetch = [&](int step) {
            const int i = step / (Ks / kSynKC);
            const int k0 = (step - i * (Ks / kSynKC)) * kSynKC;
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
                const int idx4 = tid + v * kSynThreads;
                const int row = idx4 / (kSynCols / 4);
                const int col = (idx4 - row * (kSynCols / 4)) * 4;
                if (c0 + col < hop) {
                    stage[v] = __ldg(reinterpret_cast<const float4*>(
                        basis + ((size_t)i * Kp + k_begin + k0 + row) * hop + c0 + col));
                } else {
                    stage[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                }
            }
        };
        fetch(0);
        for (int step = 0; step < n_steps; ++step) {
            const int i = step / (Ks / kSynKC);
            const int k0 = (step - i * (Ks / kSynKC)) * kSynKC;
            __syncthreads();  // previous chunk consumed
#pragma unroll
            for (int v = 0; v < kVec; ++v) {
                reinterpret_cast<float4*>(Bst)[tid + v * kSynThreads] = stage[v];
            }
            __syncthreads();
            if (step + 1 < n_steps) fetch(step + 1);
            // output chunk ty * kRPT + r reads frame row (..) + overlap - 1 - i
            const float* Srow = S + (size_t)(overlap - 1 - i) * Ks + k0;
#pragma unroll 2
            for (int kk = 0; kk < kSynKC; kk += 4) {
                float4 a[kRPT];
#pragma unroll
                for (int r = 0; r < kRPT; ++r) {
                    a[r] = *reinterpret_cast<const float4*>(Srow + rofs[r] + kk);
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4 b0 =
                        *reinterpret_cast<const float4*>(Bst + (kk + u) * kSynCols + tx * 4);
                    const float4 b1 = *reinterpret_cast<const float4*>(
                        Bst + (kk + u) * kSynCols + kSynCols / 2 + tx * 4);
#pragma unroll
                    for (int r = 0; r < kRPT; ++r) {
                        const float av =
                            u == 0 ? a[r].x : (u == 1 ? a[r].y : (u == 2 ? a[r].z : a[r].w));
                        if constexpr (kFold > 0) {
                            fma8(part[r], av, b0, b1);
                        } else {
                            fma8(acc[r], av, b0, b1);
                        }
                    }
                }
            }
            if constexpr (kFold > 0) {
                const int kc = step - i * (Ks / kSynKC) + 1;  // chunks of this piece done
                if (kc % kFold == 0 || kc == Ks / kSynKC) {
#pragma unroll
                    for (int r = 0; r < kRPT; ++r) {
#pragma unroll
                        for (int q = 0; q < 8; ++q) {
                            acc[r][q] += part[r][q];
                            part[r][q] = 0.0f;
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
            const int j = j0 + ty * kRPT + r;
            if (j >= n_chunks) continue;
            float* dst = out_row + (size_t)j * hop + c0;
            const int ca = tx * 4, cb = kSynCols / 2 + tx * 4;
            if (accumulate) {
                if (c0 + ca < hop) {
                    float4 v = *reinterpret_cast<float4*>(dst + ca);
                    v.x += acc[r][0]; v.y += acc[r][1]; v.z += acc[r][2]; v.w += acc[r][3];
                    *reinterpret_cast<float4*>(dst + ca) = v;
                }
                if (c0 + cb < hop) {
                    float4 v = *reinterpret_cast<float4*>(dst + cb);
                    v.x += acc[r][4]; v.y += acc[r][5]; v.z += acc[r][6]; v.w += acc[r][7];
                    *reinterpret_cast<float4*>(dst + cb) = v;
                }
                continue;
            }
            if (c0 + ca < hop) {
                *reinterpret_cast<float4*>(dst + ca) =
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            }
            if (c0 + cb < hop) {
                *reinterpret_cast<float4*>(dst + cb) =
                    make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
            }
        }
    }
}

}  // namespace att
