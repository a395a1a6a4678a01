// Native CSR -> block-dense packer for gato_tpu_torch.
//
// The host side of ingestion: the original solver converts CSR G and C to
// its per-knot layout on the GPU (csr_to_custom_G / csr_to_custom_C,
// gato_schur.cuh:675-756); here the conversion runs on the host, one pass
// over the CSR arrays, and the card receives dense block arrays.  The
// semantics are those of gato_tpu_torch/formats.py's NumPy path, the
// oracle, including its strict sparsity-pattern validation: an entry off
// the trajectory-QP pattern is a hard error, never a write out of bounds.
//
// A plain C ABI for ctypes (gato_tpu_torch/native.py builds it with g++).
// All index arrays are int64; matrices are float32, row-major and
// zero-initialised by the caller.
//
// Error protocol: return 0 on success; a nonzero error code with a message
// in err_buf otherwise, worded as formats.py's NumPy path words its
// ValueError.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

void fail(char* err_buf, int64_t err_len, const char* fmt, int64_t a = 0,
          int64_t b = 0) {
  if (err_buf && err_len > 0) {
    std::snprintf(err_buf, static_cast<size_t>(err_len), fmt,
                  static_cast<long long>(a), static_cast<long long>(b));
  }
}

}  // namespace

extern "C" {

// Pack the CSR cost Hessian G into Q (K,s,s) and R (K-1,c,c), both row-major.
// Rules (formats.pack_G): entry (row, col) must satisfy row/(s+c) == col/(s+c)
// (block-diagonal per knot) and live in the state-state or control-control
// quadrant; control blocks must not appear at the final knot.
int64_t gato_pack_G(const int64_t* indptr, int64_t n_rows,
                    const int64_t* indices, const float* data,
                    int64_t s, int64_t c, int64_t K,
                    float* Q_out, float* R_out,
                    char* err_buf, int64_t err_len) {
  const int64_t sc = s + c;
  const int64_t nz = sc * K - c;
  if (n_rows != nz) {
    fail(err_buf, err_len, "G has %lld rows, expected %lld", n_rows, nz);
    return 1;
  }
  for (int64_t row = 0; row < n_rows; ++row) {
    const int64_t knot = row / sc;
    const int64_t i = row % sc;
    for (int64_t it = indptr[row]; it < indptr[row + 1]; ++it) {
      const int64_t col = indices[it];
      if (col < 0 || col >= nz) {
        fail(err_buf, err_len, "G column %lld out of range", col);
        return 2;
      }
      if (col / sc != knot) {
        fail(err_buf, err_len,
             "G has entries coupling different knot points: (%lld,%lld)", row,
             col);
        return 3;
      }
      const int64_t j = col % sc;
      if (i < s && j < s) {
        Q_out[(knot * s + i) * s + j] = data[it];
      } else if (i >= s && j >= s) {
        if (knot >= K - 1) {
          fail(err_buf, err_len, "G has a control block at the final knot");
          return 4;
        }
        R_out[(knot * c + (i - s)) * c + (j - s)] = data[it];
      } else {
        fail(err_buf, err_len,
             "G has state-control cross terms: (%lld,%lld)", row, col);
        return 5;
      }
    }
  }
  return 0;
}

// Pack the CSR constraint Jacobian C into A (K-1,s,s) and B (K-1,s,c).
// Rules (formats.pack_C, the original's gato_schur.cuh:707-743): skip the first s
// rows (initial-condition identity) and entries right of the interval's
// column block (the implicit +I on x_{k+1}); reject entries left of it.
int64_t gato_pack_C(const int64_t* indptr, int64_t n_rows,
                    const int64_t* indices, const float* data,
                    int64_t s, int64_t c, int64_t K,
                    float* A_out, float* B_out,
                    char* err_buf, int64_t err_len) {
  const int64_t sc = s + c;
  const int64_t nl = s * K;
  if (n_rows != nl) {
    fail(err_buf, err_len, "C has %lld rows, expected %lld", n_rows, nl);
    return 1;
  }
  for (int64_t row = s; row < n_rows; ++row) {
    const int64_t k = row / s - 1;  // interval index
    const int64_t i = row % s;
    for (int64_t it = indptr[row]; it < indptr[row + 1]; ++it) {
      const int64_t col = indices[it];
      if (col < 0 || col >= sc * K - c) {
        // Same guard as gato_pack_G: a corrupt CSR must be a hard error, not
        // an out-of-bounds write (the original's csr_to_custom_C writes past
        // its block here, gato_schur.cuh:725-743).
        fail(err_buf, err_len, "C column %lld out of range", col);
        return 2;
      }
      const int64_t col_block = col / sc;
      if (col_block == k + 1) continue;  // identity on x_{k+1}
      if (col_block > k + 1) {
        // Only the x_{k+1} identity block is skippable; further right is
        // out-of-pattern garbage — hard error, matching formats.pack_C.
        fail(err_buf, err_len,
             "C has entries right of the x_{k+1} identity block: (%lld,%lld)",
             row, col);
        return 4;
      }
      if (col_block != k) {
        fail(err_buf, err_len,
             "C has entries left of the current interval's column block: "
             "(%lld,%lld)", row, col);
        return 3;
      }
      const int64_t j = col % sc;
      if (j < s) {
        A_out[(k * s + i) * s + j] = data[it];
      } else {
        B_out[(k * s + i) * c + (j - s)] = data[it];
      }
    }
  }
  return 0;
}

}  // extern "C"
