// Exact magnitude-ordered heap PGHI (host-side serial phase integration).
//
// The device paths use the parallel recurrence and the CUDA kernels
// (ops/pghi.py, ops/cuda/pghi_kernel.py); this native implementation provides the reference-exact
// greedy integration (the algorithm of Prusa & Sondergaard's PGHI, as used by
// the upstream library's heap integration, reference
// acids_transforms/transforms/dgt.py:168-220) at C++ speed for oracle checks
// and for users who want the exact mode offline.
//
// C ABI only — consumed through ctypes (native/pghi_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Cell {
  double mag;
  int32_t t;
  int32_t k;
};

struct CellLess {
  bool operator()(const Cell& a, const Cell& b) const { return a.mag < b.mag; }
};

}  // namespace

extern "C" {

// mag: row-major (T, F) magnitudes.  phase_out: row-major (T, F), pre-allocated.
void att_pghi(const float* mag, int32_t T, int32_t F, double gamma,
              int32_t n_fft, int32_t hop, double tol, float* phase_out) {
  const int64_t n = static_cast<int64_t>(T) * F;
  const double eps_mag = 1.19e-7;
  const double fmul = gamma / (static_cast<double>(hop) * n_fft);

  std::vector<double> m(n), logm(n), time_step(n), freq_step(n);
  double max_mag = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    m[i] = static_cast<double>(mag[i]);
    max_mag = std::max(max_mag, m[i]);
    logm[i] = std::log(std::max(m[i], eps_mag));
  }

  auto at = [F](int32_t t, int32_t k) { return static_cast<int64_t>(t) * F + k; };
  auto clamp_t = [T](int32_t t) { return std::min(std::max(t, 0), T - 1); };
  auto clamp_k = [F](int32_t k) { return std::min(std::max(k, 0), F - 1); };

  // central differences of log-magnitude with replicated edges; the Gaussian
  // Cauchy-Riemann factors give per-frame / per-bin phase increments.
  const double bin_rot = 2.0 * M_PI * hop / n_fft;
  for (int32_t t = 0; t < T; ++t) {
    for (int32_t k = 0; k < F; ++k) {
      const double dY_dk =
          (logm[at(t, clamp_k(k + 1))] - logm[at(t, clamp_k(k - 1))]) / 2.0;
      const double dY_dt =
          (logm[at(clamp_t(t + 1), k)] - logm[at(clamp_t(t - 1), k)]) / 2.0;
      time_step[at(t, k)] = dY_dk / fmul + bin_rot * k;
      freq_step[at(t, k)] = -fmul * dY_dt + M_PI;
    }
  }

  std::vector<double> phase(n, 0.0);
  std::vector<uint8_t> remaining(n);
  const double thresh = max_mag * tol;
  for (int64_t i = 0; i < n; ++i) {
    if (m[i] < thresh) m[i] = eps_mag;
    remaining[i] = m[i] > eps_mag;
  }

  std::priority_queue<Cell, std::vector<Cell>, CellLess> heap;

  auto push_seed = [&]() -> bool {
    double best = -1.0;
    int64_t best_i = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (remaining[i] && m[i] > best) {
        best = m[i];
        best_i = i;
      }
    }
    if (best_i < 0) return false;
    const int32_t t = static_cast<int32_t>(best_i / F);
    const int32_t k = static_cast<int32_t>(best_i % F);
    heap.push({best, t, k});
    remaining[best_i] = 0;
    return true;
  };

  if (!push_seed()) {
    std::memset(phase_out, 0, sizeof(float) * n);
    return;
  }

  const int32_t dts[4] = {1, -1, 0, 0};
  const int32_t dks[4] = {0, 0, 1, -1};
  const double sgn[4] = {1.0, -1.0, 1.0, -1.0};

  for (;;) {
    while (!heap.empty()) {
      const Cell c = heap.top();
      heap.pop();
      for (int d = 0; d < 4; ++d) {
        const int32_t nt = c.t + dts[d];
        const int32_t nk = c.k + dks[d];
        if (nt < 0 || nt >= T || nk < 0 || nk >= F) continue;
        const int64_t ni = at(nt, nk);
        if (!remaining[ni]) continue;
        const std::vector<double>& grad = (d < 2) ? time_step : freq_step;
        phase[ni] =
            phase[at(c.t, c.k)] + sgn[d] * (grad[at(c.t, c.k)] + grad[ni]) / 2.0;
        heap.push({m[ni], nt, nk});
        remaining[ni] = 0;
      }
    }
    if (!push_seed()) break;
  }

  for (int64_t i = 0; i < n; ++i) phase_out[i] = static_cast<float>(phase[i]);
}

}  // extern "C"
