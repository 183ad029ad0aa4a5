// Shared device functions of the chunk-factored STFT kernels (sm_90a).
//
// The windowed frame DFT of a cosine-sum window factors exactly into
//   C[c, k] = sum_{n < hop} s[c, n] e^{-2 pi i k n / n_fft}     (chunk DFT, K = hop)
//   X[t, k] = sum_{j < overlap} tw_j[k] C[t + j, k]             (twiddle combine)
//   Y[t, k] = sum_p taps_p (X[t, k - p] + X[t, k + p])          (hermitian taps conv)
// and the synthesis direction is its transpose.  Every kernel of this
// package runs one or both directions on a tile of rows held in shared
// memory; the pieces are here so that the forward, the fit statistics and
// the Griffin-Lim step share one implementation.
//
// A window that is no cosine sum (the DGT's gaussian) has no such
// factorization.  Its frame t is the contiguous slice row[t * hop, t * hop +
// n_fft) of the same rows, multiplied with a basis of n_fft x F that has the
// window folded in: the same product with contraction length n_fft instead
// of hop and no combine (analysis_tile with klen = n_fft).
//
// Arithmetic: plain fp32 FMA with fp32 accumulation everywhere (no tensor
// cores, no TF32, no bf16 split).  A block is 256 threads = 8 warps; a warp
// owns a band of rows, its lanes own columns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace att {

constexpr int kThreads = 256;
constexpr int kRowGroup = 32;   // frames (or chunks) per inner tile
constexpr int kMaxRows = 40;    // kRowGroup + overlap - 1 <= 40  (overlap <= 8)
constexpr int kColTile = 128;   // bin columns per analysis tile, halo included (4 per lane)
constexpr int kKC = 32;         // contraction chunk staged in shared memory
constexpr int kMaxTaps = 5;     // P <= 4

struct Taps {
    float c[kMaxTaps];
    int P;
};

// Column kk of the hermitian extension of a real signal's spectrum:
// X[-m] = conj X[m], X[N + m] = conj X[N - m].  Returns the bin to read and
// the sign of the imaginary part, or bin -1 where the column does not exist.
__device__ __forceinline__ void reflect_bin(int kk, int N, int* bin, float* sgn) {
    int b = kk;
    float s = 1.0f;
    if (kk < 0) {
        b = -kk;
        s = -1.0f;
    } else if (kk > N) {
        b = 2 * N - kk;
        s = -1.0f;
    }
    if (b < 0 || b > N) {
        b = -1;
    }
    *bin = b;
    *sgn = s;
}

// Shared-memory work area of one analysis column tile.
struct AnaWork {
    float* Bs;      // [2][kKC][kColTile]  staged cos / -sin basis
    float* Cre;     // [kMaxRows][kColTile] chunk DFT
    float* Cim;
    float* Xre;     // [x_rows][kColTile] combined spectrum (x_rows = kRowGroup
    float* Xim;     //   unless the caller asks for more, see carve_ana)
    int* colbin;    // [kColTile]
    float* colsgn;  // [kColTile]
};

// x_rows: rows of the combined spectrum the caller asks analysis_tile for
// (n_frames <= x_rows <= kMaxRows); the representation kernels take one
// halo frame more than kRowGroup.
__host__ __device__ constexpr int ana_work_floats(int x_rows = kRowGroup) {
    return 2 * kKC * kColTile + 2 * kMaxRows * kColTile + 2 * x_rows * kColTile +
           2 * kColTile;
}

__device__ __forceinline__ AnaWork carve_ana(float* base, int x_rows = kRowGroup) {
    AnaWork w;
    w.Bs = base;
    w.Cre = w.Bs + 2 * kKC * kColTile;
    w.Cim = w.Cre + kMaxRows * kColTile;
    w.Xre = w.Cim + kMaxRows * kColTile;
    w.Xim = w.Xre + x_rows * kColTile;
    w.colbin = reinterpret_cast<int*>(w.Xim + x_rows * kColTile);
    w.colsgn = reinterpret_cast<float*>(w.colbin + kColTile);
    return w;
}

// Number of column tiles covering bins 0..N with P halo columns per side.
__host__ __device__ __forceinline__ int n_col_tiles(int F, int P) {
    int useful = kColTile - 2 * P;
    return (F + useful - 1) / useful;
}

// Analysis of one column tile: rows `As` (n_rows x hop floats, row stride
// hop, in shared memory) -> combined spectrum X[t][c] for t < n_frames,
// c < kColTile, in w.Xre / w.Xim.  Column c is bin kk0 + c of the hermitian
// extension, kk0 = ct * (kColTile - 2P) - P, so that the taps conv of the
// caller finds its neighbours inside the tile.  n_rows = n_frames + overlap
// - 1 <= kMaxRows.  Ends with a __syncthreads(): X is readable on return.
//
// klen > 0 selects the full-K front end: row r is the frame As[r * hop, r *
// hop + klen) (n_rows = n_frames of them, overlapping), bcos / bsin are the
// window-folded (klen, F) basis, and X is the product itself (twr / twi are
// not read; P = 0).
//
// Two pieces, called in turn: chunk_product, then twiddle_combine.  The floor
// sweep (csrc/spectral.cu:melspec_stage_kernel) stops after the first.

// The chunk product of one column tile: w.colbin / w.colsgn for its columns,
// and C[r][c] = sum_n As[r][n] B[n][colbin[c]] for r < n_rows in w.Cre /
// w.Cim (the raw product: no hermitian sign applied).  Ends with a
// __syncthreads(): C is readable on return.
static __device__ void chunk_product(const float* As, int n_rows, int hop, int F, int ct, int P,
                                     const float* __restrict__ bcos,
                                     const float* __restrict__ bsin, AnaWork w, int klen = 0) {
    const int tid = threadIdx.x;
    const int tx = tid & 31;
    const int ty = tid >> 5;
    const int N = F - 1;
    const int kk0 = ct * (kColTile - 2 * P) - P;
    const int K = klen > 0 ? klen : hop;  // contraction length

    __syncthreads();  // previous users of the work area are done
    if (tid < kColTile) {
        int bin;
        float sgn;
        reflect_bin(kk0 + tid, N, &bin, &sgn);
        w.colbin[tid] = bin;
        w.colsgn[tid] = sgn;
    }

    // Thread tile: RPT rows x 4 adjacent bins x (re, im) = 40 accumulators, so
    // that each shared-memory load feeds enough multiply-adds: per k a lane
    // loads its rows' samples (one float4 per row and 4 k, broadcast) and two
    // float4 of basis for RPT * 8 FMAs.
    constexpr int RPT = kMaxRows / 8;  // rows per thread
    float acc_re[RPT][4], acc_im[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            acc_re[i][q] = 0.0f;
            acc_im[i][q] = 0.0f;
        }
    }
    int rows[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        int r = ty * RPT + i;
        rows[i] = r < n_rows ? r : n_rows - 1;
    }
    // a warp whose rows all lie past n_rows only helps staging the basis
    const bool warp_active = ty * RPT < n_rows;

    float* Bc = w.Bs;
    float* Bsn = w.Bs + kKC * kColTile;
    // A thread stages one basis column over every second row of a chunk.  The
    // next chunk's values are loaded into registers before the current chunk
    // is multiplied, so their latency hides behind the FMAs; all loads of a
    // chunk are independent and in flight together.
    constexpr int kRowsPer = kKC * kColTile / kThreads;
    constexpr int kRowStep = kThreads / kColTile;
    const int stage_c = tid % kColTile;
    const int stage_r = tid / kColTile;
    float vc[kRowsPer], vs[kRowsPer];
    __syncthreads();  // colbin visible
    const int stage_bin = w.colbin[stage_c];
    auto fetch = [&](int n0) {
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
            size_t o = (size_t)(n0 + stage_r + i * kRowStep) * F + (stage_bin >= 0 ? stage_bin : 0);
            vc[i] = __ldg(bcos + o);
            vs[i] = __ldg(bsin + o);
        }
    };
    fetch(0);
    for (int n0 = 0; n0 < K; n0 += kKC) {
        __syncthreads();  // previous chunk consumed
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
            int kk = stage_r + i * kRowStep;
            Bc[kk * kColTile + stage_c] = stage_bin >= 0 ? vc[i] : 0.0f;
            Bsn[kk * kColTile + stage_c] = stage_bin >= 0 ? vs[i] : 0.0f;
        }
        __syncthreads();
        if (n0 + kKC < K) fetch(n0 + kKC);
        if (!warp_active) continue;
#pragma unroll 2
        for (int kk = 0; kk < kKC; kk += 4) {
            float4 a[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                a[i] = *reinterpret_cast<const float4*>(As + (size_t)rows[i] * hop + n0 + kk);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float4 bc = *reinterpret_cast<const float4*>(Bc + (kk + u) * kColTile + tx * 4);
                const float4 bs = *reinterpret_cast<const float4*>(Bsn + (kk + u) * kColTile + tx * 4);
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    float av = u == 0 ? a[i].x : (u == 1 ? a[i].y : (u == 2 ? a[i].z : a[i].w));
                    acc_re[i][0] = fmaf(av, bc.x, acc_re[i][0]);
                    acc_re[i][1] = fmaf(av, bc.y, acc_re[i][1]);
                    acc_re[i][2] = fmaf(av, bc.z, acc_re[i][2]);
                    acc_re[i][3] = fmaf(av, bc.w, acc_re[i][3]);
                    acc_im[i][0] = fmaf(av, bs.x, acc_im[i][0]);
                    acc_im[i][1] = fmaf(av, bs.y, acc_im[i][1]);
                    acc_im[i][2] = fmaf(av, bs.z, acc_im[i][2]);
                    acc_im[i][3] = fmaf(av, bs.w, acc_im[i][3]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        int r = ty * RPT + i;
        if (r < n_rows) {
            *reinterpret_cast<float4*>(w.Cre + r * kColTile + tx * 4) =
                make_float4(acc_re[i][0], acc_re[i][1], acc_re[i][2], acc_re[i][3]);
            *reinterpret_cast<float4*>(w.Cim + r * kColTile + tx * 4) =
                make_float4(acc_im[i][0], acc_im[i][1], acc_im[i][2], acc_im[i][3]);
        }
    }
    __syncthreads();
}

// The twiddle combine of one column tile: frame t collects chunks t + j of
// chunk_product's C, for t < n_frames, with the hermitian sign (full-K: X is
// C itself).  Ends with a __syncthreads(): X is readable on return.
static __device__ void twiddle_combine(int n_frames, int overlap, int F,
                                       const float* __restrict__ twr,
                                       const float* __restrict__ twi, AnaWork w, bool fullk) {
    for (int idx = threadIdx.x; idx < n_frames * kColTile; idx += kThreads) {
        int t = idx / kColTile;
        int c = idx - t * kColTile;
        int bin = w.colbin[c];
        float xr = 0.0f, xi = 0.0f;
        if (bin >= 0 && fullk) {
            xr = w.Cre[idx];
            xi = w.Cim[idx] * w.colsgn[c];
        } else if (bin >= 0) {
            for (int j = 0; j < overlap; ++j) {
                float wr = __ldg(twr + (size_t)j * F + bin);
                float wi = __ldg(twi + (size_t)j * F + bin);
                float cr = w.Cre[(t + j) * kColTile + c];
                float ci = w.Cim[(t + j) * kColTile + c];
                xr += wr * cr - wi * ci;
                xi += wr * ci + wi * cr;
            }
            xi *= w.colsgn[c];
        }
        w.Xre[idx] = xr;
        w.Xim[idx] = xi;
    }
    __syncthreads();
}

static __device__ void analysis_tile(const float* As, int n_rows, int n_frames, int hop,
                                     int overlap, int F, int ct, int P,
                                     const float* __restrict__ bcos,
                                     const float* __restrict__ bsin,
                                     const float* __restrict__ twr,
                                     const float* __restrict__ twi, AnaWork w, int klen = 0) {
    chunk_product(As, n_rows, hop, F, ct, P, bcos, bsin, w, klen);
    twiddle_combine(n_frames, overlap, F, twr, twi, w, klen > 0);
}

// Taps conv of the combined spectrum at tile column c (P <= c < kColTile - P).
__device__ __forceinline__ void taps_at(const AnaWork& w, const Taps& taps, int t, int c,
                                        float* yre, float* yim) {
    const float* xr = w.Xre + t * kColTile + c;
    const float* xi = w.Xim + t * kColTile + c;
    float re = taps.c[0] * xr[0];
    float im = taps.c[0] * xi[0];
    for (int p = 1; p <= taps.P; ++p) {
        re += taps.c[p] * (xr[-p] + xr[p]);
        im += taps.c[p] * (xi[-p] + xi[p]);
    }
    *yre = re;
    *yim = im;
}

}  // namespace att
