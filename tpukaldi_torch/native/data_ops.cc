// tpukaldi native host data-plane ops.
//
// The reference delegates its host feature transforms to external Kaldi C++
// binaries through shell pipes (SURVEY.md §2.3); tpukaldi runs them
// in-process.  numpy handles most of the arithmetic fine, but the chunk
// assembly hot path benefits from fused, cache-friendly C++:
//   - splice(): context-window splicing writes each output row once instead
//     of numpy's one full-matrix roll+copy per lag (11 copies for cw 5/5);
//   - chunk_cmvn(): single-pass Welford mean/var + in-place normalize;
//   - add_deltas(): fused FIR over time with edge clamping;
//   - apply_cmvn(): speaker mean/var normalization from Kaldi stats;
//   - decode_cm1(): Kaldi compressed-matrix (format 1) -> float32.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Built by tpukaldi/native/__init__.py with g++ -O3 -march=native.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// out must hold (n - left - right) * d * (left + right + 1) floats.
// Roll semantics identical to the reference's context_window
// (data_io.py:228-241): lag columns ordered [-left .. +right], circular
// wrap INSIDE the first/last `left`/`right` rows which are then dropped.
void tk_splice(const float* in, int64_t n, int64_t d, int64_t left,
               int64_t right, float* out) {
  const int64_t lags = left + right + 1;
  const int64_t out_rows = n - left - right;
  for (int64_t r = 0; r < out_rows; ++r) {
    float* dst = out + r * d * lags;
    const int64_t src_row = r + left;  // center row in input coordinates
    for (int64_t l = -left; l <= right; ++l) {
      // np.roll(fea, -lag)[src_row] == fea[(src_row + lag) mod n]
      int64_t row = src_row + l;
      if (row < 0) row += n;
      if (row >= n) row -= n;
      std::memcpy(dst, in + row * d, sizeof(float) * d);
      dst += d;
    }
  }
}

// In-place per-column mean/std normalization (population std, matching
// np.std / data_io.py:263).  Row-major two-pass: per-column double
// accumulators updated while streaming rows (cache-friendly), then one
// row-major normalize pass.
void tk_chunk_cmvn(float* x, int64_t n, int64_t d) {
  double* sum = new double[2 * d]();
  double* sumsq = sum + d;
  const float* p = x;
  for (int64_t r = 0; r < n; ++r, p += d) {
    for (int64_t c = 0; c < d; ++c) {
      const double v = p[c];
      sum[c] += v;
      sumsq[c] += v * v;
    }
  }
  float* mean_f = new float[2 * d];
  float* inv_f = mean_f + d;
  for (int64_t c = 0; c < d; ++c) {
    const double mean = sum[c] / n;
    const double var = sumsq[c] / n - mean * mean;
    const double std = std::sqrt(var > 0 ? var : 0);
    mean_f[c] = static_cast<float>(mean);
    inv_f[c] = static_cast<float>(std > 0 ? 1.0 / std : 0.0);
  }
  float* q = x;
  for (int64_t r = 0; r < n; ++r, q += d) {
    for (int64_t c = 0; c < d; ++c) {
      q[c] = (q[c] - mean_f[c]) * inv_f[c];
    }
  }
  delete[] sum;
  delete[] mean_f;
}

// Speaker CMVN from Kaldi stats layout: stats is 2 x (d+1) doubles-as-float:
// row0 = sums with count in last cell, row1 = sumsq.
void tk_apply_cmvn(float* x, int64_t n, int64_t d, const double* stats,
                   int norm_vars) {
  const double count = stats[d];
  for (int64_t c = 0; c < d; ++c) {
    const double mean = stats[c] / count;
    double scale = 1.0;
    if (norm_vars) {
      const double var = stats[(d + 1) + c] / count - mean * mean;
      scale = 1.0 / std::sqrt(var > 1e-20 ? var : 1e-20);
    }
    for (int64_t r = 0; r < n; ++r) {
      x[r * d + c] = static_cast<float>((x[r * d + c] - mean) * scale);
    }
  }
}

// Delta features with Kaldi's least-squares slope filters and edge
// clamping.  scales: concatenated per-order coefficient arrays;
// offsets[o] = start index, lens[o] = length, for o in [0, order].
// out must hold n * d * (order+1).
void tk_add_deltas(const float* in, int64_t n, int64_t d, int order,
                   const double* scales, const int64_t* offsets,
                   const int64_t* lens, float* out) {
  const int blocks = order + 1;
  for (int o = 0; o < blocks; ++o) {
    const double* coef = scales + offsets[o];
    const int64_t len = lens[o];
    const int64_t half = (len - 1) / 2;
    for (int64_t r = 0; r < n; ++r) {
      float* dst = out + r * d * blocks + o * d;
      for (int64_t c = 0; c < d; ++c) dst[c] = 0.0f;
      for (int64_t j = 0; j < len; ++j) {
        const double w = coef[j];
        if (w == 0.0) continue;
        int64_t row = r + (j - half);
        if (row < 0) row = 0;
        if (row >= n) row = n - 1;
        const float* src = in + row * d;
        for (int64_t c = 0; c < d; ++c) {
          dst[c] += static_cast<float>(w * src[c]);
        }
      }
    }
  }
}

// Kaldi CompressedMatrix format 1: headers = cols x 4 uint16 percentiles,
// data = cols x rows uint8 (column-major).  min/range from GlobalHeader.
void tk_decode_cm1(const uint16_t* headers, const uint8_t* data, float min_v,
                   float range, int64_t rows, int64_t cols, float* out) {
  const double scale16 = range * (1.0 / 65535.0);
  for (int64_t c = 0; c < cols; ++c) {
    const double p0 = min_v + scale16 * headers[c * 4 + 0];
    const double p25 = min_v + scale16 * headers[c * 4 + 1];
    const double p75 = min_v + scale16 * headers[c * 4 + 2];
    const double p100 = min_v + scale16 * headers[c * 4 + 3];
    const double s_lo = (p25 - p0) / 64.0;
    const double s_mid = (p75 - p25) / 128.0;
    const double s_hi = (p100 - p75) / 63.0;
    const uint8_t* col = data + c * rows;
    for (int64_t r = 0; r < rows; ++r) {
      const int v = col[r];
      double val;
      if (v <= 64) {
        val = p0 + s_lo * v;
      } else if (v <= 192) {
        val = p25 + s_mid * (v - 64);
      } else {
        val = p75 + s_hi * (v - 192);
      }
      out[r * cols + c] = static_cast<float>(val);
    }
  }
}

}  // extern "C"
