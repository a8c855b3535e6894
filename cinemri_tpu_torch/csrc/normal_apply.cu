// Masked normal operator apply on planar (re, im) float32 operands.
//
//   out[b,t] = Σ_c conj(S[b,c]) ⊙ (K[b,t'] ·_h (S[b,c] ⊙ x[b,t])) + λ·x[b,t]
//
//   x, out: (b, t, h, w)   K: (b, kt, h, h), t' = t if kt > 1 else 0
//   S: (b, c, h, w)        λ: one float32 in device memory (read by the kernel,
//                          so a learned λ never goes through the host)
//
// K acts along h: (K ·_h y)[i, w] = Σ_k K[i, k] · y[k, w].
//
// Replaces the forward Pallas kernel normal_apply_pallas / fwd_pallas_call
// (cinemri_tpu/ops/kernels/normal_pallas.py, body _fwd_kernel). It carries
// N(z) in every VarNet cascade's data-consistency step (λ = 0) and every
// CineNet conjugate-gradient apply (λ = softplus of a learned weight)
// through physics/operators.py::normal_plus_lambda_kernel.
//
// Arithmetic: the 4-multiplication complex product in full f32 on CUDA
// cores (FMA, no TF32), matching the JAX package's Precision.HIGHEST.
//
// What bounds it on the H100: per apply it does 8·t·c·h·h·w FLOP (9.6 GFLOP
// at t=15, c=10, h=w=200) against about 18 MB of traffic, so it is bound by
// the FP32 rate. The Pallas program keeps a whole (h, w) plane, K and the
// coil stack on chip (about 8 MB) and relies on the TPU's sequential grid
// to fetch S once per batch row; neither carries over to a block's 227 KB
// of shared memory and blocks that run in no order.
//
// Design: the grid runs over (w-tile, h-tile, b·t). A block owns a BH x BW
// tile of out, loops over the coils and, per coil, over BK-deep chunks of
// the contraction: it stages K[h-tile, k-chunk] and y = S_c ⊙ x on
// [k-chunk, w-tile] (formed while loading) in shared memory, accumulates
// z = K·y for its tile in registers, then folds acc += conj(S_c) ⊙ z before
// the next coil. Only x, K, S and out touch device memory; the
// coil-expanded intermediates never do.

#include <cuda_runtime.h>

namespace {

template <int BH, int BW, int BK, int TM, int TN>
__global__ void __launch_bounds__((BH / TM) * (BW / TN))
normal_apply_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const float* __restrict__ kr, const float* __restrict__ ki,
                    const float* __restrict__ sr, const float* __restrict__ si,
                    const float* __restrict__ lamp, float* __restrict__ outr,
                    float* __restrict__ outi, int T, int C, int H, int W, int KT) {
  constexpr int TX = BW / TN;  // threads along w
  constexpr int TY = BH / TM;  // threads along h
  constexpr int NT = TX * TY;
  __shared__ float skr[BK][BH + 1], ski[BK][BH + 1];  // K[i, k], stored k-major
  __shared__ float syr[BK][BW], syi[BK][BW];          // y[k, w]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int w0 = blockIdx.x * BW;
  const int i0 = blockIdx.y * BH;
  const int bt = blockIdx.z;
  const int b = bt / T;
  const int t = bt % T;

  const long plane = static_cast<long>(H) * W;
  const float* xrp = xr + bt * plane;
  const float* xip = xi + bt * plane;
  const long koff = (static_cast<long>(b) * KT + (KT > 1 ? t : 0)) * H * H;
  const float* krp = kr + koff;
  const float* kip = ki + koff;

  float accr[TM][TN], acci[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) accr[m][n] = acci[m][n] = 0.f;

  for (int c = 0; c < C; ++c) {
    const float* srp = sr + (static_cast<long>(b) * C + c) * plane;
    const float* sip = si + (static_cast<long>(b) * C + c) * plane;

    float zr[TM][TN], zi[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) zr[m][n] = zi[m][n] = 0.f;

    for (int k0 = 0; k0 < H; k0 += BK) {
      for (int idx = tid; idx < BH * BK; idx += NT) {
        const int r = idx / BK, kk = idx % BK;
        const int i = i0 + r, k = k0 + kk;
        const bool ok = i < H && k < H;
        const long g = static_cast<long>(i) * H + k;
        skr[kk][r] = ok ? krp[g] : 0.f;
        ski[kk][r] = ok ? kip[g] : 0.f;
      }
      for (int idx = tid; idx < BK * BW; idx += NT) {
        const int kk = idx / BW, col = idx % BW;
        const int k = k0 + kk, w = w0 + col;
        float yr = 0.f, yi = 0.f;
        if (k < H && w < W) {
          const long g = static_cast<long>(k) * W + w;
          const float a = srp[g], bb = sip[g], u = xrp[g], v = xip[g];
          yr = a * u - bb * v;
          yi = a * v + bb * u;
        }
        syr[kk][col] = yr;
        syi[kk][col] = yi;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          ar[m] = skr[kk][ty + TY * m];
          ai[m] = ski[kk][ty + TY * m];
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          br[n] = syr[kk][tx + TX * n];
          bi[n] = syi[kk][tx + TX * n];
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            zr[m][n] = fmaf(ar[m], br[n], zr[m][n]);
            zr[m][n] = fmaf(-ai[m], bi[n], zr[m][n]);
            zi[m][n] = fmaf(ar[m], bi[n], zi[m][n]);
            zi[m][n] = fmaf(ai[m], br[n], zi[m][n]);
          }
      }
      __syncthreads();
    }

    // acc += conj(S_c) ⊙ z
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = i0 + ty + TY * m;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int w = w0 + tx + TX * n;
        if (i < H && w < W) {
          const long g = static_cast<long>(i) * W + w;
          const float a = srp[g], bb = sip[g];
          accr[m][n] += a * zr[m][n] + bb * zi[m][n];
          acci[m][n] += a * zi[m][n] - bb * zr[m][n];
        }
      }
    }
  }

  const float lam = *lamp;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = i0 + ty + TY * m;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int w = w0 + tx + TX * n;
      if (i < H && w < W) {
        const long g = bt * plane + static_cast<long>(i) * W + w;
        outr[g] = accr[m][n] + lam * xr[g];
        outi[g] = acci[m][n] + lam * xi[g];
      }
    }
  }
}

}  // namespace

extern "C" int cinemri_normal_apply(const float* xr, const float* xi,
                                    const float* kr, const float* ki,
                                    const float* sr, const float* si, const float* lam,
                                    float* outr, float* outi, int b, int t,
                                    int c, int h, int w, int kt, void* stream) {
  constexpr int BH = 64, BW = 64, BK = 16, TM = 4, TN = 4;
  constexpr int threads = (BH / TM) * (BW / TN);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, b * t);
  normal_apply_kernel<BH, BW, BK, TM, TN>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          xr, xi, kr, ki, sr, si, lam, outr, outi, t, c, h, w, kt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
