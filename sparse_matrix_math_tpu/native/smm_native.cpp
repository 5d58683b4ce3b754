// Native host-side runtime for sparse_matrix_math_tpu.
//
// Device compute (SpMV, solver loops) runs as XLA programs; the inherently
// sequential host-side work — incomplete factorizations and file
// ingestion — runs natively, mirroring the role of the reference C++
// library's host code:
//   * IC(0):  reference include/sparse_matrix_math.h:1839-1928
//   * ILU(0): reference include/sparse_matrix_math.h:1727-1790 (completed
//             here; the reference version is unfinished — SURVEY §2.1 #14)
//   * Matrix Market loader: reference include/sparse_matrix_math.h:2524-2609
//
// Exposed as a C ABI for ctypes (no pybind11 in this toolchain).
// Status codes match the Python-side enums.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// IC(0): A ~= L L^T restricted to the lower-triangular pattern of A.
//
// Up-looking row algorithm over CSR arrays.  The caller extracts the lower
// pattern (ascending columns per row, diagonal last) and the matching A
// values:
//   l_indptr  : (n+1) row pointers into the lower pattern
//   l_indices : lower-pattern column ids (ascending; last per row == row)
//   a_lower   : A's values on that pattern (input)
//   l_values  : output L values on the same pattern
// Returns 0 on success; 2 on non-positive pivot (err_row = offending row).
// (Missing diagonals are detected by the Python wrapper before the call.)
// ---------------------------------------------------------------------------
int smm_ic0_factorize(int64_t n, const int64_t* l_indptr,
                      const int64_t* l_indices, const double* a_lower,
                      double* l_values, int64_t* err_row) {
  std::vector<double> w(static_cast<size_t>(n), 0.0);
  std::vector<int64_t> stamp(static_cast<size_t>(n), -1);

  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = l_indptr[i], hi = l_indptr[i + 1];
    for (int64_t p = lo; p < hi; ++p) {
      const int64_t col = l_indices[p];
      stamp[col] = i;
      w[col] = a_lower[p];
    }
    // strictly-lower columns j (ascending):
    //   L(i,j) = (A(i,j) - sum_{k<j} L(i,k) L(j,k)) / L(j,j)
    for (int64_t p = lo; p < hi - 1; ++p) {
      const int64_t j = l_indices[p];
      double s = w[j];
      const int64_t jlo = l_indptr[j], jhi = l_indptr[j + 1];
      for (int64_t q = jlo; q < jhi - 1; ++q) {  // k < j in L's row j
        const int64_t k = l_indices[q];
        if (stamp[k] == i) s -= l_values[q] * w[k];
      }
      w[j] = s / l_values[jhi - 1];  // diag of row j
    }
    // diagonal: L(i,i) = sqrt(A(i,i) - sum_k L(i,k)^2)
    double d = w[i];
    for (int64_t p = lo; p < hi - 1; ++p) {
      const double v = w[l_indices[p]];
      d -= v * v;
    }
    if (!(d > 0.0)) {  // also catches NaN
      *err_row = i;
      return 2;
    }
    w[i] = std::sqrt(d);
    for (int64_t p = lo; p < hi; ++p) l_values[p] = w[l_indices[p]];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// ILU(0): incomplete LU with zero fill on the pattern of A (IKJ form,
// Saad §10.3.2).  `factor` enters as a copy of A's values and leaves with
// L (strict lower, unit diagonal implicit) and U (diagonal + upper).
// `diag_pos` gives the CSR position of each row's diagonal (precomputed).
// Returns 0 ok; 3 on zero pivot (err_row set).
// ---------------------------------------------------------------------------
// pivot_tol: pivots with |pivot| <= pivot_tol are treated as zero
// (err 3) — a data-dependent NEAR-zero pivot produces an unusable
// factor just as surely as an exact zero; the caller escalates through
// diagonal shifts (precond/_factorize.py).
int smm_ilu0_factorize(int64_t n, const int64_t* indptr,
                       const int64_t* indices, const int64_t* diag_pos,
                       double* factor, double pivot_tol,
                       int64_t* err_row) {
  std::vector<int64_t> pos(static_cast<size_t>(n), -1);
  std::vector<int64_t> stamp(static_cast<size_t>(n), -1);

  for (int64_t i = 1; i < n; ++i) {
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    for (int64_t p = lo; p < hi; ++p) {
      stamp[indices[p]] = i;
      pos[indices[p]] = p;
    }
    for (int64_t p = lo; p < hi; ++p) {
      const int64_t k = indices[p];
      if (k >= i) break;
      const double pivot = factor[diag_pos[k]];
      if (std::fabs(pivot) <= pivot_tol) {
        *err_row = k;
        return 3;
      }
      const double alpha = factor[p] / pivot;
      factor[p] = alpha;
      for (int64_t q = diag_pos[k] + 1; q < indptr[k + 1]; ++q) {
        const int64_t j = indices[q];
        if (stamp[j] == i) factor[pos[j]] -= alpha * factor[q];
      }
    }
    if (std::fabs(factor[diag_pos[i]]) <= pivot_tol) {
      *err_row = i;
      return 3;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Matrix Market loader (reference grammar: matrix coordinate real|integer,
// symmetric — h:2544-2573; `allow_general` extends to general).
// Status codes match MatrixLoadStatus: 0 SUCCESS, 1 FAILED_TO_OPEN_FILE,
// 3 PARSE_ERROR, 4 UNSUPPORTED_FORMAT.
// ---------------------------------------------------------------------------

static int mtx_parse_banner(FILE* f, int* symmetric, int allow_general) {
  char line[65536];
  if (!std::fgets(line, sizeof line, f)) return 3;
  char tag[64], obj[64], fmt[64], field[64], sym[64];
  if (std::sscanf(line, "%63s %63s %63s %63s %63s", tag, obj, fmt, field,
                  sym) != 5)
    return 3;
  if (std::strcmp(tag, "%%MatrixMarket") != 0) return 3;
  for (char* s : {obj, fmt, field, sym})
    for (char* c = s; *c; ++c) *c = (char)std::tolower(*c);
  if (std::strcmp(obj, "matrix") != 0 || std::strcmp(fmt, "coordinate") != 0)
    return 4;
  if (std::strcmp(field, "real") != 0 && std::strcmp(field, "integer") != 0)
    return 4;
  *symmetric = std::strcmp(sym, "symmetric") == 0;
  if (!*symmetric && !(allow_general && std::strcmp(sym, "general") == 0))
    return 4;
  return 0;
}

static int mtx_read_size(FILE* f, int64_t* rows, int64_t* cols, int64_t* nnz) {
  char line[65536];
  while (std::fgets(line, sizeof line, f)) {
    const char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '%') continue;
    if (*s == '\n' || *s == '\r' || *s == '\0') continue;
    long long r, c, z;
    char extra[8];
    if (std::sscanf(s, "%lld %lld %lld %7s", &r, &c, &z, extra) != 3) return 3;
    *rows = r; *cols = c; *nnz = z;
    return 0;
  }
  return 3;
}

int smm_mtx_header(const char* path, int64_t* rows, int64_t* cols,
                   int64_t* nnz, int* symmetric, int allow_general) {
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  int st = mtx_parse_banner(f, symmetric, allow_general);
  if (st == 0) st = mtx_read_size(f, rows, cols, nnz);
  std::fclose(f);
  return st;
}

// Writes up to `cap` (row, col, value) triplets (0-based, symmetric entries
// mirrored — reference h:2596-2601).  `count` = triplets written;
// `bad_line` = 1-based offending line on parse error.
int smm_mtx_read(const char* path, int allow_general, int64_t cap,
                 int64_t* r_out, int64_t* c_out, double* v_out,
                 int64_t* count, int64_t* bad_line) {
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  int symmetric = 0;
  int st = mtx_parse_banner(f, &symmetric, allow_general);
  int64_t rows = 0, cols = 0, nnz = 0;
  if (st == 0) st = mtx_read_size(f, &rows, &cols, &nnz);
  if (st != 0) {
    std::fclose(f);
    return st;
  }
  char line[65536];
  int64_t written = 0, entries = 0, lineno = 2;
  while (std::fgets(line, sizeof line, f)) {
    ++lineno;
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '%' || *s == '\n' || *s == '\r' || *s == '\0') continue;
    char* end = nullptr;
    const long long r1 = std::strtoll(s, &end, 10);
    if (end == s) goto parse_err;
    s = end;
    const long long c1 = std::strtoll(s, &end, 10);
    if (end == s) goto parse_err;
    s = end;
    {
      const double v = std::strtod(s, &end);
      if (end == s) goto parse_err;
      // nothing but whitespace may follow (reference rejects junk columns)
      while (*end == ' ' || *end == '\t' || *end == '\n' || *end == '\r') ++end;
      if (*end != '\0') goto parse_err;
      const int64_t r = r1 - 1, c = c1 - 1;  // 1-based input (h:2595-2596)
      if (r < 0 || r >= rows || c < 0 || c >= cols) goto parse_err;
      if (written >= cap) goto parse_err;
      r_out[written] = r; c_out[written] = c; v_out[written] = v;
      ++written;
      if (symmetric && r != c) {
        if (written >= cap) goto parse_err;
        r_out[written] = c; c_out[written] = r; v_out[written] = v;
        ++written;
      }
      ++entries;
    }
  }
  std::fclose(f);
  if (entries != nnz) {
    *bad_line = lineno;
    return 3;
  }
  *count = written;
  return 0;

parse_err:
  std::fclose(f);
  *bad_line = lineno;
  return 3;
}

}  // extern "C"
