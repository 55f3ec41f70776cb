// arap.cpp — self-contained 2-D As-Rigid-As-Possible mesh deformation.
//
// Native replacement for the reference's libigl subprocess
// (ref: wrap_codes/wrap_triangle/libigl_arap/my_arap.cpp: file-based OBJ I/O,
// igl::arap_precomputation + arap_solve, 100 iterations).  Same local-global
// algorithm (Sorkine & Alexa 2007, spokes energy, cotangent weights):
//   local step: per-vertex optimal rotation via closed-form 2x2 polar
//               decomposition of the weighted covariance,
//   global step: SPD screened-Laplacian solve by conjugate gradients.
// Exposed as an in-process C ABI for ctypes — no files, no subprocesses.
// The port's own copy of ctrlhair_tpu/native/arap.cpp; built at first use
// by ctrlhair_tpu_torch/utils/cuda_build.HostLibrary.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Edge { int j; double w; };

// CG solve of (L x = b) restricted to free vertices; constrained vertices'
// values are folded into b by the caller.  L is given by adjacency lists.
void cg_solve(const std::vector<std::vector<Edge>>& adj,
              const std::vector<double>& diag,
              const std::vector<char>& is_free,
              std::vector<double>& x, const std::vector<double>& b,
              int max_iter, double tol) {
  const int n = (int)x.size();
  std::vector<double> r(n, 0.0), p(n, 0.0), ap(n, 0.0);

  auto apply = [&](const std::vector<double>& v, std::vector<double>& out) {
    for (int i = 0; i < n; ++i) {
      if (!is_free[i]) { out[i] = 0.0; continue; }
      double acc = diag[i] * v[i];
      for (const Edge& e : adj[i])
        if (is_free[e.j]) acc -= e.w * v[e.j];
      out[i] = acc;
    }
  };

  apply(x, ap);
  double rs = 0.0;
  for (int i = 0; i < n; ++i) {
    r[i] = is_free[i] ? b[i] - ap[i] : 0.0;
    p[i] = r[i];
    rs += r[i] * r[i];
  }
  const double stop = tol * tol * (rs > 0 ? rs : 1.0);
  for (int it = 0; it < max_iter && rs > stop; ++it) {
    apply(p, ap);
    double pap = 0.0;
    for (int i = 0; i < n; ++i) pap += p[i] * ap[i];
    if (pap <= 0.0) break;
    const double alpha = rs / pap;
    double rs_new = 0.0;
    for (int i = 0; i < n; ++i) {
      x[i] += alpha * p[i];
      r[i] -= alpha * ap[i];
      rs_new += r[i] * r[i];
    }
    const double beta = rs_new / rs;
    for (int i = 0; i < n; ++i) p[i] = r[i] + beta * p[i];
    rs = rs_new;
  }
}

}  // namespace

extern "C" int arap_solve_2d(const double* verts, int n_verts,
                             const int* tris, int n_tris,
                             const int* constrained_idx, int n_constrained,
                             const double* constrained_pos, int iterations,
                             double* out_verts) {
  if (n_verts <= 0 || n_tris <= 0) return 1;

  // --- cotangent weights over the triangle fan ---------------------------
  std::vector<std::vector<Edge>> adj(n_verts);
  auto add_weight = [&](int i, int j, double w) {
    for (Edge& e : adj[i]) {
      if (e.j == j) { e.w += w; return; }
    }
    adj[i].push_back({j, w});
  };
  for (int t = 0; t < n_tris; ++t) {
    const int* f = tris + 3 * t;
    for (int c = 0; c < 3; ++c) {
      const int i = f[c], j = f[(c + 1) % 3], k = f[(c + 2) % 3];
      const double ax = verts[2 * i] - verts[2 * k];
      const double ay = verts[2 * i + 1] - verts[2 * k + 1];
      const double bx = verts[2 * j] - verts[2 * k];
      const double by = verts[2 * j + 1] - verts[2 * k + 1];
      const double cross = std::fabs(ax * by - ay * bx);
      const double dot = ax * bx + ay * by;
      double cot = dot / (cross > 1e-12 ? cross : 1e-12);
      // clamp degenerate-angle weights for robustness (igl does similar
      // guarding internally)
      if (cot < -10.0) cot = -10.0;
      if (cot > 10.0) cot = 10.0;
      add_weight(i, j, 0.5 * cot);
      add_weight(j, i, 0.5 * cot);
    }
  }

  std::vector<double> diag(n_verts, 0.0);
  for (int i = 0; i < n_verts; ++i)
    for (const Edge& e : adj[i]) diag[i] += e.w;

  std::vector<char> is_free(n_verts, 1);
  std::vector<double> u(2 * (size_t)n_verts);
  std::memcpy(u.data(), verts, sizeof(double) * 2 * n_verts);
  for (int c = 0; c < n_constrained; ++c) {
    const int idx = constrained_idx[c];
    if (idx < 0 || idx >= n_verts) return 2;
    is_free[idx] = 0;
    u[2 * idx] = constrained_pos[2 * c];
    u[2 * idx + 1] = constrained_pos[2 * c + 1];
  }

  std::vector<double> rot(2 * (size_t)n_verts);  // per-vertex (cos, sin)
  std::vector<double> bx(n_verts), by(n_verts), xx(n_verts), xy(n_verts);

  for (int iter = 0; iter < iterations; ++iter) {
    // local step: best-fit rotation per vertex (2x2 polar decomposition)
    for (int i = 0; i < n_verts; ++i) {
      double s00 = 0, s01 = 0, s10 = 0, s11 = 0;
      for (const Edge& e : adj[i]) {
        const double ex = verts[2 * i] - verts[2 * e.j];
        const double ey = verts[2 * i + 1] - verts[2 * e.j + 1];
        const double fx = u[2 * i] - u[2 * e.j];
        const double fy = u[2 * i + 1] - u[2 * e.j + 1];
        s00 += e.w * ex * fx; s01 += e.w * ex * fy;
        s10 += e.w * ey * fx; s11 += e.w * ey * fy;
      }
      // R = argmax tr(R S): closed form for 2x2
      const double a = s00 + s11, b = s01 - s10;
      const double norm = std::sqrt(a * a + b * b);
      if (norm > 1e-12) {
        rot[2 * i] = a / norm;       // cos
        rot[2 * i + 1] = b / norm;   // sin
      } else {
        rot[2 * i] = 1.0;
        rot[2 * i + 1] = 0.0;
      }
    }

    // global step rhs: b_i = sum_j w_ij/2 (R_i + R_j)(v_i - v_j)
    for (int i = 0; i < n_verts; ++i) {
      double accx = 0, accy = 0;
      const double ci = rot[2 * i], si = rot[2 * i + 1];
      for (const Edge& e : adj[i]) {
        const double cj = rot[2 * e.j], sj = rot[2 * e.j + 1];
        const double ex = verts[2 * i] - verts[2 * e.j];
        const double ey = verts[2 * i + 1] - verts[2 * e.j + 1];
        const double cm = 0.5 * (ci + cj), sm = 0.5 * (si + sj);
        // R(theta) applied as [[c,-s],[s,c]]
        accx += e.w * 0.5 * 2.0 * (cm * ex - sm * ey);
        accy += e.w * 0.5 * 2.0 * (sm * ex + cm * ey);
        // fold constrained neighbours into rhs
        if (!is_free[e.j]) {
          accx += e.w * u[2 * e.j];
          accy += e.w * u[2 * e.j + 1];
        }
      }
      bx[i] = accx;
      by[i] = accy;
    }

    for (int i = 0; i < n_verts; ++i) { xx[i] = u[2 * i]; xy[i] = u[2 * i + 1]; }
    cg_solve(adj, diag, is_free, xx, bx, 200, 1e-8);
    cg_solve(adj, diag, is_free, xy, by, 200, 1e-8);
    double max_move = 0.0;
    for (int i = 0; i < n_verts; ++i) {
      if (is_free[i]) {
        const double dx = xx[i] - u[2 * i], dy = xy[i] - u[2 * i + 1];
        const double m = std::fabs(dx) + std::fabs(dy);
        if (m > max_move) max_move = m;
        u[2 * i] = xx[i]; u[2 * i + 1] = xy[i];
      }
    }
    // fixed-point early exit: the local-global alternation typically
    // converges in 10-30 sweeps; below 1e-4 px per sweep further
    // iterations change nothing visible (the reference always runs the
    // full 100, my_arap.cpp:183)
    if (max_move < 1e-4) break;
  }

  std::memcpy(out_verts, u.data(), sizeof(double) * 2 * n_verts);
  return 0;
}
