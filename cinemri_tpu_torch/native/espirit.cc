// ESPIRiT coil-sensitivity calibration — standalone C++ implementation.
//
// Mirrors the offline role of the BART toolbox's `ecalib` (C), which the
// reference invokes from Python inside every dataset __getitem__
// (reconstruction/data/mri_data.py:294-298, data/transforms.py:425-432).
// This library implements the same algorithm as cinemri_tpu_torch/data/espirit.py
// (Gram-matrix nullspace + kernel-autocorrelation assembly of the pointwise
// operator + per-pixel leading eigenvector); the two are cross-validated in
// tests/test_native.py. No external dependencies: the Hermitian
// eigendecomposition is a cyclic Jacobi sweep, the per-pixel leading
// eigenvector is a warm-started power iteration, and the small-support
// inverse DFT is evaluated as two separable passes.
//
// Exposed C ABI (ctypes-friendly, split re/im float32 buffers):
//   int espirit_maps_f32(kre, kim, c, h, w, calib, kernel, thresh, crop,
//                        mre, mim, eig)
// Returns 0 on success.

#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

using cd = std::complex<double>;

namespace {

// ---------------------------------------------------------------- Jacobi eigh
// Cyclic Jacobi for a complex Hermitian matrix A (n x n, row-major).
// On return: w holds ascending eigenvalues, V columns the eigenvectors.
void jacobi_eigh(std::vector<cd>& a, int n, std::vector<double>& w,
                 std::vector<cd>& v) {
  v.assign(static_cast<size_t>(n) * n, cd(0, 0));
  for (int i = 0; i < n; ++i) v[static_cast<size_t>(i) * n + i] = 1.0;

  auto A = [&](int i, int j) -> cd& { return a[static_cast<size_t>(i) * n + j]; };
  auto V = [&](int i, int j) -> cd& { return v[static_cast<size_t>(i) * n + j]; };

  const int max_sweeps = 30;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    double off = 0;
    for (int i = 0; i < n; ++i)
      for (int j = i + 1; j < n; ++j) off += std::norm(A(i, j));
    if (off < 1e-22) break;

    for (int p = 0; p < n; ++p) {
      for (int q = p + 1; q < n; ++q) {
        cd apq = A(p, q);
        double mag = std::abs(apq);
        if (mag < 1e-300) continue;
        double app = A(p, p).real();
        double aqq = A(q, q).real();
        // Complex Jacobi rotation: diagonalize the 2x2 [[app, apq],[apq*, aqq]].
        cd phase = apq / mag;  // e^{i arg(apq)}
        double tau = (aqq - app) / (2.0 * mag);
        double t = (tau >= 0 ? 1.0 : -1.0) / (std::abs(tau) + std::sqrt(1 + tau * tau));
        double cth = 1.0 / std::sqrt(1 + t * t);
        double sth = t * cth;
        cd s = phase * sth;  // rotation applies e^{i phi}

        for (int k = 0; k < n; ++k) {
          cd akp = A(k, p), akq = A(k, q);
          A(k, p) = cth * akp - std::conj(s) * akq;
          A(k, q) = s * akp + cth * akq;
        }
        for (int k = 0; k < n; ++k) {
          cd apk = A(p, k), aqk = A(q, k);
          A(p, k) = cth * apk - s * aqk;
          A(q, k) = std::conj(s) * apk + cth * aqk;
        }
        for (int k = 0; k < n; ++k) {
          cd vkp = V(k, p), vkq = V(k, q);
          V(k, p) = cth * vkp - std::conj(s) * vkq;
          V(k, q) = s * vkp + cth * vkq;
        }
      }
    }
  }

  // sort ascending by eigenvalue (selection sort on columns)
  w.resize(n);
  for (int i = 0; i < n; ++i) w[i] = A(i, i).real();
  for (int i = 0; i < n; ++i) {
    int m = i;
    for (int j = i + 1; j < n; ++j)
      if (w[j] < w[m]) m = j;
    if (m != i) {
      std::swap(w[i], w[m]);
      for (int k = 0; k < n; ++k) std::swap(V(k, i), V(k, m));
    }
  }
}

}  // namespace

extern "C" {

int espirit_maps_f32(const float* kre, const float* kim, int c, int h, int w,
                     int calib_size, int kernel_size, float thresh, float crop,
                     float* mre, float* mim, float* eig) {
  const int k = kernel_size;
  const int ch = calib_size < h ? calib_size : h;
  const int cw = calib_size < w ? calib_size : w;
  if (ch < k || cw < k || c < 1) return 1;
  const int h0 = (h - ch) / 2, w0 = (w - cw) / 2;
  const int nh = ch - k + 1, nw = cw - k + 1;
  const int n = c * k * k;  // Gram dimension

  // calibration region, (c, ch, cw)
  std::vector<cd> calib(static_cast<size_t>(c) * ch * cw);
  for (int ci = 0; ci < c; ++ci)
    for (int y = 0; y < ch; ++y)
      for (int x = 0; x < cw; ++x) {
        size_t src = (static_cast<size_t>(ci) * h + (h0 + y)) * w + (w0 + x);
        calib[(static_cast<size_t>(ci) * ch + y) * cw + x] = cd(kre[src], kim[src]);
      }

  // Gram = A^H A with patch index (coil, dy, dx); A rows are patch positions.
  std::vector<cd> gram(static_cast<size_t>(n) * n, cd(0, 0));
  {
    std::vector<cd> row(n);
    for (int py = 0; py < nh; ++py)
      for (int px = 0; px < nw; ++px) {
        for (int ci = 0; ci < c; ++ci)
          for (int dy = 0; dy < k; ++dy)
            for (int dx = 0; dx < k; ++dx)
              row[(static_cast<size_t>(ci) * k + dy) * k + dx] =
                  calib[(static_cast<size_t>(ci) * ch + py + dy) * cw + px + dx];
        for (int i = 0; i < n; ++i)
          for (int j = 0; j < n; ++j)
            gram[static_cast<size_t>(i) * n + j] += row[i] * std::conj(row[j]);
      }
  }

  // signal-subspace projector P = V diag(sigma^2 > t^2 sigma_max^2) V^H
  std::vector<double> evals;
  std::vector<cd> evecs;
  jacobi_eigh(gram, n, evals, evecs);
  const double cut = static_cast<double>(thresh) * thresh * evals[n - 1];
  std::vector<cd> proj(static_cast<size_t>(n) * n, cd(0, 0));
  for (int e = 0; e < n; ++e) {
    if (evals[e] <= cut) continue;
    for (int i = 0; i < n; ++i) {
      cd vi = evecs[static_cast<size_t>(i) * n + e];
      for (int j = 0; j < n; ++j)
        proj[static_cast<size_t>(i) * n + j] +=
            vi * std::conj(evecs[static_cast<size_t>(j) * n + e]);
    }
  }

  // kernel autocorrelation Q_cc'(dy, dx), support (2k-1)^2
  const int m = 2 * k - 1;
  std::vector<cd> q(static_cast<size_t>(c) * c * m * m, cd(0, 0));
  auto P = [&](int ci, int dy1, int dx1, int cj, int dy2, int dx2) -> cd {
    int i = (ci * k + dy1) * k + dx1;
    int j = (cj * k + dy2) * k + dx2;
    return proj[static_cast<size_t>(i) * n + j];
  };
  for (int ci = 0; ci < c; ++ci)
    for (int cj = 0; cj < c; ++cj)
      for (int dy = -k + 1; dy <= k - 1; ++dy)
        for (int dx = -k + 1; dx <= k - 1; ++dx) {
          cd s(0, 0);
          for (int y = 0; y < k; ++y) {
            int y1 = y + dy;
            if (y1 < 0 || y1 >= k) continue;
            for (int x = 0; x < k; ++x) {
              int x1 = x + dx;
              if (x1 < 0 || x1 >= k) continue;
              s += P(ci, y1, x1, cj, y, x);
            }
          }
          q[((static_cast<size_t>(ci) * c + cj) * m + (dy + k - 1)) * m +
            (dx + k - 1)] = s;
        }

  // G_cc'(x, y) = (1/k^2) sum_D Q(D) e^{2 pi i (Dy (x - h/2)/h + Dx (y - w/2)/w)}
  // evaluated separably: first over Dx -> R(dy, y), then over Dy -> G(x, y).
  std::vector<cd> ph_y(static_cast<size_t>(m) * h), ph_x(static_cast<size_t>(m) * w);
  for (int d = 0; d < m; ++d) {
    int delta = d - (k - 1);
    for (int x = 0; x < h; ++x)
      ph_y[static_cast<size_t>(d) * h + x] =
          std::polar(1.0, 2.0 * M_PI * delta * (x - h / 2) / static_cast<double>(h));
    for (int y = 0; y < w; ++y)
      ph_x[static_cast<size_t>(d) * w + y] =
          std::polar(1.0, 2.0 * M_PI * delta * (y - w / 2) / static_cast<double>(w));
  }

  std::vector<cd> g(static_cast<size_t>(c) * c * h * w, cd(0, 0));
  {
    std::vector<cd> r(static_cast<size_t>(m) * w);
    for (int ci = 0; ci < c; ++ci)
      for (int cj = 0; cj < c; ++cj) {
        std::fill(r.begin(), r.end(), cd(0, 0));
        for (int dy = 0; dy < m; ++dy)
          for (int dx = 0; dx < m; ++dx) {
            cd qv = q[((static_cast<size_t>(ci) * c + cj) * m + dy) * m + dx];
            if (std::norm(qv) == 0) continue;
            const cd* px = &ph_x[static_cast<size_t>(dx) * w];
            cd* rr = &r[static_cast<size_t>(dy) * w];
            for (int y = 0; y < w; ++y) rr[y] += qv * px[y];
          }
        cd* gc = &g[(static_cast<size_t>(ci) * c + cj) * h * w];
        for (int dy = 0; dy < m; ++dy) {
          const cd* py = &ph_y[static_cast<size_t>(dy) * h];
          const cd* rr = &r[static_cast<size_t>(dy) * w];
          for (int x = 0; x < h; ++x) {
            cd f = py[x] / static_cast<double>(k * k);
            cd* row = &gc[static_cast<size_t>(x) * w];
            for (int y = 0; y < w; ++y) row[y] += f * rr[y];
          }
        }
      }
  }

  // per-pixel leading eigenvector via warm-started power iteration
  std::vector<cd> vec(c, cd(1.0 / std::sqrt(static_cast<double>(c)), 0));
  std::vector<cd> tmp(c);
  for (int x = 0; x < h; ++x) {
    for (int y = 0; y < w; ++y) {
      double lam = 0;
      for (int it = 0; it < 400; ++it) {
        double nrm = 0;
        for (int ci = 0; ci < c; ++ci) {
          cd s(0, 0);
          for (int cj = 0; cj < c; ++cj)
            s += g[(static_cast<size_t>(ci) * c + cj) * h * w +
                   static_cast<size_t>(x) * w + y] *
                 vec[cj];
          tmp[ci] = s;
          nrm += std::norm(s);
        }
        nrm = std::sqrt(nrm);
        if (nrm < 1e-12) {
          lam = 0;
          break;
        }
        double new_lam = nrm;  // since |v|=1, |Gv| approximates lambda
        for (int ci = 0; ci < c; ++ci) vec[ci] = tmp[ci] / nrm;
        if (it > 8 && std::abs(new_lam - lam) < 1e-12 * (new_lam + 1e-30)) {
          lam = new_lam;
          break;
        }
        lam = new_lam;
      }

      size_t pix = static_cast<size_t>(x) * w + y;
      eig[pix] = static_cast<float>(lam);
      if (lam >= crop) {
        // phase-reference to coil 0
        cd ph = vec[0];
        double amag = std::abs(ph);
        cd rot = amag > 1e-14 ? std::conj(ph) / amag : cd(1, 0);
        for (int ci = 0; ci < c; ++ci) {
          cd v = vec[ci] * rot;
          mre[static_cast<size_t>(ci) * h * w + pix] = static_cast<float>(v.real());
          mim[static_cast<size_t>(ci) * h * w + pix] = static_cast<float>(v.imag());
        }
      } else {
        for (int ci = 0; ci < c; ++ci) {
          mre[static_cast<size_t>(ci) * h * w + pix] = 0;
          mim[static_cast<size_t>(ci) * h * w + pix] = 0;
        }
        // reset the warm start after a gap
        for (int ci = 0; ci < c; ++ci)
          vec[ci] = cd(1.0 / std::sqrt(static_cast<double>(c)), 0);
      }
    }
  }
  return 0;
}

}  // extern "C"
