// Native host runtime of rails_tpu_torch: the port's own copy of the JAX
// package's rails_tpu/native/librails_host.cpp, with the same C interface.
//
// Provides the host-side components the reference implements natively:
//  - MatrixMarket coordinate parsing (the role of the reference's
//    EpetraExt::MatrixMarketFileToCrsMatrix, src/main.cpp:62-72)
//  - serial sparse LU with partial pivoting, Gilbert-Peierls left-looking
//    (the Amesos/KLU role for the Schur-complement A11 solve, the
//    reference's src/SchurOperator.cpp:177-186), with transpose solves
//    (both directions are first-class).
//
// Built with plain g++ at first use into build/rails_tpu_torch/
// (rails_tpu_torch/_build.py::load_host) and bound with ctypes
// (rails_tpu_torch/native/host_lib.py).  No external dependencies.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket
// ---------------------------------------------------------------------------

// Returns 0 on success (coordinate real/integer/pattern, general or
// symmetric); nonzero means the caller should fall back to another reader.
int rails_mm_read_header(const char *path, int64_t *rows, int64_t *cols,
                         int64_t *nnz, int64_t *symmetric) {
  FILE *f = std::fopen(path, "r");
  if (!f) return 1;
  char line[512];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return 2; }
  std::string header(line);
  for (auto &c : header) c = std::tolower(c);
  if (header.find("%%matrixmarket") == std::string::npos ||
      header.find("coordinate") == std::string::npos ||
      header.find("complex") != std::string::npos ||
      header.find("hermitian") != std::string::npos ||
      header.find("skew") != std::string::npos) {
    std::fclose(f);
    return 3;
  }
  *symmetric = header.find("symmetric") != std::string::npos ? 1 : 0;
  // skip comments
  long pos = std::ftell(f);
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '%') { pos = std::ftell(f); continue; }
    break;
  }
  std::fseek(f, pos, SEEK_SET);
  long long r = 0, c = 0, z = 0;
  if (std::fscanf(f, "%lld %lld %lld", &r, &c, &z) != 3) {
    std::fclose(f);
    return 4;
  }
  *rows = r; *cols = c; *nnz = z;
  std::fclose(f);
  return 0;
}

// Fills ii/jj (0-based) and vv with up to cap entries; returns count read
// or -1 on error.  Pattern files get value 1.0.
int64_t rails_mm_read_coo(const char *path, int64_t *ii, int64_t *jj,
                          double *vv, int64_t cap) {
  FILE *f = std::fopen(path, "r");
  if (!f) return -1;
  char line[512];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -1; }
  std::string header(line);
  for (auto &c : header) c = std::tolower(c);
  bool pattern = header.find("pattern") != std::string::npos;
  long pos = std::ftell(f);
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '%') { pos = std::ftell(f); continue; }
    break;
  }
  std::fseek(f, pos, SEEK_SET);
  long long r, c, z;
  if (std::fscanf(f, "%lld %lld %lld", &r, &c, &z) != 3) {
    std::fclose(f);
    return -1;
  }
  int64_t count = 0;
  while (count < cap) {
    long long i, j;
    double v = 1.0;
    int got = pattern ? std::fscanf(f, "%lld %lld", &i, &j)
                      : std::fscanf(f, "%lld %lld %lf", &i, &j, &v);
    if (got != (pattern ? 2 : 3)) break;
    ii[count] = i - 1;
    jj[count] = j - 1;
    vv[count] = v;
    ++count;
  }
  std::fclose(f);
  return count;
}

// ---------------------------------------------------------------------------
// Sparse LU (Gilbert-Peierls, left-looking, partial pivoting)
// ---------------------------------------------------------------------------

struct SpLU {
  int64_t n;
  // L: unit lower triangular, columns in pivoted row coordinates
  std::vector<std::vector<int64_t>> l_idx;
  std::vector<std::vector<double>> l_val;
  // U: strictly-upper entries per column (pivoted rows < j) + diagonal
  std::vector<std::vector<int64_t>> u_idx;
  std::vector<std::vector<double>> u_val;
  std::vector<double> u_diag;
  std::vector<int64_t> perm;  // perm[j] = original row pivoted at step j
};

void *rails_splu_factor(int64_t n, const int64_t *colptr,
                        const int64_t *rowidx, const double *val) {
  SpLU *lu = new SpLU;
  lu->n = n;
  lu->l_idx.resize(n); lu->l_val.resize(n);
  lu->u_idx.resize(n); lu->u_val.resize(n);
  lu->u_diag.assign(n, 0.0);
  lu->perm.assign(n, -1);

  std::vector<int64_t> pinv(n, -1);          // orig row -> pivot position
  std::vector<double> x(n, 0.0);             // dense work column
  std::vector<int64_t> pattern;              // nonzero rows of x (orig)
  std::vector<char> mark(n, 0);
  std::vector<int64_t> stack, order, child_pos;
  pattern.reserve(64);

  // L columns are kept in *original* row indices during the factorization
  // (pivot positions of later rows are unknown); converted afterwards.
  for (int64_t j = 0; j < n; ++j) {
    // --- symbolic: reachability of A(:,j)'s pattern through L ---
    order.clear();
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
      int64_t r = rowidx[p];
      if (mark[r]) continue;
      // iterative DFS
      stack.clear(); child_pos.clear();
      stack.push_back(r); child_pos.push_back(0);
      mark[r] = 1;
      while (!stack.empty()) {
        int64_t node = stack.back();
        int64_t k = pinv[node];
        bool descended = false;
        if (k >= 0) {
          auto &kids = lu->l_idx[k];
          for (int64_t &cp = child_pos.back(); cp < (int64_t)kids.size();) {
            int64_t kid = kids[cp++];
            if (!mark[kid]) {
              mark[kid] = 1;
              stack.push_back(kid);
              child_pos.push_back(0);
              descended = true;
              break;
            }
          }
        }
        if (!descended) {
          order.push_back(node);  // postorder = topological for the solve
          stack.pop_back();
          child_pos.pop_back();
        }
      }
    }
    // --- numeric: scatter A(:,j), then eliminate in topological order ---
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
      x[rowidx[p]] += val[p];
    for (int64_t t = (int64_t)order.size() - 1; t >= 0; --t) {
      int64_t r = order[t];
      int64_t k = pinv[r];
      if (k < 0) continue;
      double xr = x[r];
      if (xr == 0.0) continue;
      auto &li = lu->l_idx[k];
      auto &lv = lu->l_val[k];
      for (size_t q = 0; q < li.size(); ++q) x[li[q]] -= lv[q] * xr;
    }
    // --- pivot: largest magnitude among not-yet-pivoted rows ---
    int64_t piv = -1;
    double best = 0.0;
    for (int64_t t = 0; t < (int64_t)order.size(); ++t) {
      int64_t r = order[t];
      if (pinv[r] < 0) {
        double a = std::fabs(x[r]);
        if (a > best) { best = a; piv = r; }
      }
    }
    if (piv < 0) {  // structurally/numerically singular column
      for (int64_t r = 0; r < n; ++r)
        if (pinv[r] < 0) { piv = r; break; }
      x[piv] = 1e-300;
    }
    double d = x[piv];
    lu->u_diag[j] = d;
    // --- store columns, clear work ---
    for (int64_t t = 0; t < (int64_t)order.size(); ++t) {
      int64_t r = order[t];
      double xr = x[r];
      int64_t k = pinv[r];
      if (k >= 0) {
        if (xr != 0.0) {
          lu->u_idx[j].push_back(k);
          lu->u_val[j].push_back(xr);
        }
      } else if (r != piv && xr != 0.0) {
        lu->l_idx[j].push_back(r);        // original row for now
        lu->l_val[j].push_back(xr / d);
      }
      x[r] = 0.0;
      mark[r] = 0;
    }
    pinv[piv] = j;
    lu->perm[j] = piv;
  }
  // finalize: convert L row indices to pivot positions
  for (int64_t j = 0; j < n; ++j)
    for (auto &r : lu->l_idx[j]) r = pinv[r];
  return lu;
}

// In-place solve of nrhs stacked columns (each of length n, contiguous).
// trans=0: A x = b;  trans=1: A' x = b.
int rails_splu_solve(void *handle, double *b, int64_t nrhs, int trans) {
  SpLU *lu = (SpLU *)handle;
  if (!lu) return 1;
  int64_t n = lu->n;
  std::vector<double> z(n);
  for (int64_t col = 0; col < nrhs; ++col) {
    double *bc = b + col * n;
    if (!trans) {
      // z = P b; z = L^{-1} z; x = U^{-1} z
      for (int64_t j = 0; j < n; ++j) z[j] = bc[lu->perm[j]];
      for (int64_t j = 0; j < n; ++j) {
        double v = z[j];
        if (v == 0.0) continue;
        auto &li = lu->l_idx[j];
        auto &lv = lu->l_val[j];
        for (size_t q = 0; q < li.size(); ++q) z[li[q]] -= lv[q] * v;
      }
      for (int64_t j = n - 1; j >= 0; --j) {
        double xj = z[j] / lu->u_diag[j];
        z[j] = xj;
        auto &ui = lu->u_idx[j];
        auto &uv = lu->u_val[j];
        for (size_t q = 0; q < ui.size(); ++q) z[ui[q]] -= uv[q] * xj;
      }
      std::memcpy(bc, z.data(), n * sizeof(double));
    } else {
      // A' = U' L' P:  U' y = b (forward), L' w = y (backward), x = P' w
      for (int64_t j = 0; j < n; ++j) {
        double acc = bc[j];
        auto &ui = lu->u_idx[j];
        auto &uv = lu->u_val[j];
        for (size_t q = 0; q < ui.size(); ++q) acc -= uv[q] * z[ui[q]];
        z[j] = acc / lu->u_diag[j];
      }
      for (int64_t j = n - 1; j >= 0; --j) {
        double acc = z[j];
        auto &li = lu->l_idx[j];
        auto &lv = lu->l_val[j];
        for (size_t q = 0; q < li.size(); ++q) acc -= lv[q] * z[li[q]];
        z[j] = acc;
      }
      for (int64_t j = 0; j < n; ++j) bc[lu->perm[j]] = z[j];
    }
  }
  return 0;
}

void rails_splu_free(void *handle) { delete (SpLU *)handle; }

}  // extern "C"
