// C++ CPU oracle for the Walsh-Hadamard numerics.
//
// Role-parity with the reference's libtorch C++ extension
// (src/fwht/cpp/fwht.cpp:3-34, "only used for testing" per its
// README.md:64): an independent, dependency-free implementation that the
// Python test-suite compares the JAX paths against. Unlike the
// reference extension this operates on raw buffers (no framework types),
// transforms along the last axis (matching the whvi_tpu convention), and
// also provides the fused WHVI product so the structured-matrix algebra
// has a second, non-JAX oracle.
//
// Build: g++ -O3 -march=native -shared -fPIC fwht_oracle.cpp -o libfwht_oracle.so
// (driven by whvi_tpu/ops/cpu_oracle.py, which caches the .so).

#include <cstdint>
#include <cstddef>

extern "C" {

// In-place iterative FWHT along the last axis of a row-major (batch, n)
// buffer; n must be a power of two. Unnormalized Sylvester convention:
// applying twice multiplies by n.
void fwht_f32(float* data, int64_t batch, int64_t n) {
  for (int64_t r = 0; r < batch; ++r) {
    float* row = data + r * n;
    for (int64_t h = 1; h < n; h <<= 1) {
      for (int64_t i = 0; i < n; i += h << 1) {
        for (int64_t j = i; j < i + h; ++j) {
          const float a = row[j];
          const float b = row[j + h];
          row[j] = a + b;
          row[j + h] = a - b;
        }
      }
    }
  }
}

void fwht_f64(double* data, int64_t batch, int64_t n) {
  for (int64_t r = 0; r < batch; ++r) {
    double* row = data + r * n;
    for (int64_t h = 1; h < n; h <<= 1) {
      for (int64_t i = 0; i < n; i += h << 1) {
        for (int64_t j = i; j < i + h; ++j) {
          const double a = row[j];
          const double b = row[j + h];
          row[j] = a + b;
          row[j + h] = a - b;
        }
      }
    }
  }
}

// Fused WHVI product: out[r, :] = s1 * H(u * H(s2 * x[r, :])).
// Row-major x (batch, n) -> out (batch, n); diagonals length n.
// Computed in double internally for oracle-grade accuracy.
void whvi_mul_f64(const double* x, const double* s1, const double* u,
                  const double* s2, double* out, int64_t batch, int64_t n) {
  for (int64_t r = 0; r < batch; ++r) {
    double* row = out + r * n;
    const double* xin = x + r * n;
    for (int64_t j = 0; j < n; ++j) row[j] = s2[j] * xin[j];
    fwht_f64(row, 1, n);
    for (int64_t j = 0; j < n; ++j) row[j] *= u[j];
    fwht_f64(row, 1, n);
    for (int64_t j = 0; j < n; ++j) row[j] *= s1[j];
  }
}

}  // extern "C"
