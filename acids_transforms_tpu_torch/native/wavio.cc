// Native WAV decode/encode + Kaiser-sinc polyphase resampling.
//
// The data-ingestion path of the framework (the role torchaudio.load /
// Resample plays for the reference, acids_transforms/utils/misc.py:29-59):
// RIFF parsing (PCM 8/16/24/32, IEEE float32/64, EXTENSIBLE; BWF `bext` and
// other chunks skipped), deinterleave to (channels, n) float32, and a
// rational-ratio windowed-sinc resampler.  C ABI via ctypes
// (native/wavio_native.py); the numpy implementation in utils/misc.py is the
// plain version and oracle.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

double bessel_i0(double x) {
  // series expansion; converges quickly for the beta range we use
  double sum = 1.0, term = 1.0;
  const double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (static_cast<double>(k) * k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

}  // namespace

extern "C" {

void att_free(void* p) { std::free(p); }

// Returns 0 on success.  *out is malloc'd (channels * n_samples floats,
// channel-major); caller frees with att_free.
int att_load_wav(const char* path, float** out, int32_t* channels,
                 int64_t* n_samples, int32_t* sr) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return 2;
  }
  std::fclose(f);

  if (size < 12 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return 3;

  const uint8_t* fmt = nullptr;
  size_t fmt_size = 0;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
  size_t pos = 12;
  while (pos + 8 <= buf.size()) {
    const uint8_t* cid = buf.data() + pos;
    const uint32_t csize = rd_u32(buf.data() + pos + 4);
    const uint8_t* body = buf.data() + pos + 8;
    if (pos + 8 + csize > buf.size()) break;
    if (std::memcmp(cid, "fmt ", 4) == 0) {
      fmt = body;
      fmt_size = csize;
    } else if (std::memcmp(cid, "data", 4) == 0) {
      data = body;
      data_size = csize;
    }
    pos += 8 + csize + (csize & 1);
  }
  if (!fmt || !data || fmt_size < 16) return 4;

  uint16_t fmt_code = rd_u16(fmt);
  const uint16_t ch = rd_u16(fmt + 2);
  const uint32_t rate = rd_u32(fmt + 4);
  const uint16_t bits = rd_u16(fmt + 14);
  if (fmt_code == 0xFFFE && fmt_size >= 26) fmt_code = rd_u16(fmt + 24);
  if (ch == 0) return 5;

  const size_t bytes_per = bits / 8;
  const int64_t frames = static_cast<int64_t>(data_size / (bytes_per * ch));
  float* y = static_cast<float*>(std::malloc(sizeof(float) * frames * ch));
  if (!y) return 6;

  for (int64_t i = 0; i < frames; ++i) {
    for (int32_t c = 0; c < ch; ++c) {
      const uint8_t* p = data + (i * ch + c) * bytes_per;
      double v = 0.0;
      if (fmt_code == 3 && bits == 32) {
        float tmp;
        std::memcpy(&tmp, p, 4);
        v = tmp;
      } else if (fmt_code == 3 && bits == 64) {
        double tmp;
        std::memcpy(&tmp, p, 8);
        v = tmp;
      } else if (fmt_code == 1 && bits == 16) {
        int16_t tmp;
        std::memcpy(&tmp, p, 2);
        v = tmp / 32768.0;
      } else if (fmt_code == 1 && bits == 32) {
        int32_t tmp;
        std::memcpy(&tmp, p, 4);
        v = tmp / 2147483648.0;
      } else if (fmt_code == 1 && bits == 24) {
        int32_t tmp = p[0] | (p[1] << 8) | (p[2] << 16);
        if (tmp >= (1 << 23)) tmp -= (1 << 24);
        v = tmp / 8388608.0;
      } else if (fmt_code == 1 && bits == 8) {
        v = (static_cast<int>(p[0]) - 128) / 128.0;
      } else {
        std::free(y);
        return 7;
      }
      y[static_cast<int64_t>(c) * frames + i] = static_cast<float>(v);
    }
  }
  *out = y;
  *channels = ch;
  *n_samples = frames;
  *sr = static_cast<int32_t>(rate);
  return 0;
}

int att_save_wav(const char* path, const float* x, int32_t channels,
                 int64_t n_samples, int32_t sr) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const uint32_t body = static_cast<uint32_t>(n_samples * channels * 4);
  const uint32_t block = channels * 4;
  uint8_t hdr[44];
  std::memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + body;
  std::memcpy(hdr + 4, &riff, 4);
  std::memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_len = 16;
  std::memcpy(hdr + 16, &fmt_len, 4);
  uint16_t code = 3, ch16 = static_cast<uint16_t>(channels);
  std::memcpy(hdr + 20, &code, 2);
  std::memcpy(hdr + 22, &ch16, 2);
  std::memcpy(hdr + 24, &sr, 4);
  uint32_t byte_rate = sr * block;
  std::memcpy(hdr + 28, &byte_rate, 4);
  uint16_t block16 = static_cast<uint16_t>(block), bits = 32;
  std::memcpy(hdr + 32, &block16, 2);
  std::memcpy(hdr + 34, &bits, 2);
  std::memcpy(hdr + 36, "data", 4);
  std::memcpy(hdr + 40, &body, 4);
  std::fwrite(hdr, 1, 44, f);
  // interleave
  for (int64_t i = 0; i < n_samples; ++i)
    for (int32_t c = 0; c < channels; ++c)
      std::fwrite(&x[static_cast<int64_t>(c) * n_samples + i], 4, 1, f);
  std::fclose(f);
  return 0;
}

// Kaiser-windowed sinc polyphase resampler; *out is malloc'd, caller frees.
int att_resample(const float* x, int32_t channels, int64_t n_in, int32_t sr_in,
                 int32_t sr_out, float** out, int64_t* n_out_p) {
  if (sr_in == sr_out) {
    float* y = static_cast<float*>(std::malloc(sizeof(float) * n_in * channels));
    if (!y) return 1;
    std::memcpy(y, x, sizeof(float) * n_in * channels);
    *out = y;
    *n_out_p = n_in;
    return 0;
  }
  const int64_t g = std::gcd(static_cast<int64_t>(sr_in), static_cast<int64_t>(sr_out));
  const int64_t up = sr_out / g, down = sr_in / g;
  const double fc = 0.5 * std::min(1.0, static_cast<double>(up) / down);
  const int zeros = 24;
  const double half_width = zeros / (2.0 * fc);
  const int K = static_cast<int>(std::ceil(half_width));
  const double beta = 9.0;
  const double i0b = bessel_i0(beta);

  const int64_t n_out = (n_in * up + down - 1) / down;
  float* y = static_cast<float*>(std::malloc(sizeof(float) * n_out * channels));
  if (!y) return 1;

  // per-phase tap tables
  std::vector<std::vector<double>> taps(static_cast<size_t>(up));
  for (int64_t r = 0; r < up; ++r) {
    taps[r].resize(2 * K + 1);
    const double frac = static_cast<double>(r) / up;
    for (int k = -K; k <= K; ++k) {
      const double t = frac - k;
      double w = 0.0;
      if (std::fabs(t) <= half_width) {
        const double arg = 1.0 - (t / half_width) * (t / half_width);
        const double kaiser = bessel_i0(beta * std::sqrt(std::max(0.0, arg))) / i0b;
        const double s = (t == 0.0) ? 1.0 : std::sin(2.0 * M_PI * fc * t) / (2.0 * M_PI * fc * t);
        w = 2.0 * fc * s * kaiser;
      }
      taps[r][k + K] = w;
    }
  }

  for (int32_t c = 0; c < channels; ++c) {
    const float* xc = x + static_cast<int64_t>(c) * n_in;
    float* yc = y + static_cast<int64_t>(c) * n_out;
    for (int64_t m = 0; m < n_out; ++m) {
      const int64_t num = m * down;
      const int64_t base = num / up;
      const int64_t r = num % up;
      const std::vector<double>& h = taps[static_cast<size_t>(r)];
      double acc = 0.0;
      for (int k = -K; k <= K; ++k) {
        const int64_t j = base + k;
        if (j >= 0 && j < n_in) acc += h[k + K] * xc[j];
      }
      yc[m] = static_cast<float>(acc);
    }
  }
  *out = y;
  *n_out_p = n_out;
  return 0;
}

}  // extern "C"
