// Complex DFT product y = x · Wᵀ on planar (re, im) float32 operands.
//
//   y[b, j] = Σ_k W[j, k] · x[b, k]      x: (B, N), W: (N, N), y: (B, N)
//
// Replaces the Pallas kernel complex_dft_matmul_pallas
// (cinemri_tpu/ops/kernels/dft_pallas.py, body _kernel). Every centered
// 1-D DFT of the port goes through it (ops/fft.py::_apply_dft).
//
// Arithmetic: the 4-multiplication complex product in full f32 on CUDA
// cores (FMA, no TF32), matching the JAX package's Precision.HIGHEST:
//   yr += xr·wr − xi·wi;   yi += xr·wi + xi·wr.
//
// Design: a plain tiled SGEMM. Each block owns a BM x BN tile of y and
// walks the contraction in BK-deep chunks; the chunk of x (BM x BK) and of
// W (BN x BK) is staged in shared memory, stored k-major so the inner loop
// reads contiguous rows; each thread accumulates a TM x TN sub-tile of both
// yr and yi in registers. Thread (tx, ty) owns rows ty + TY·m and columns
// tx + TX·n, so neighbouring threads read neighbouring shared-memory words
// and write neighbouring output columns. The Pallas kernel keeps all of W
// resident on chip; at N = 200 the three N x N matrices take 480 KB, more
// than a block's shared memory, hence the contraction tiling.
//
// What bounds it on the H100: at N = 200 (the image-axis transforms) the
// product is 8·N FLOP per output against 16 bytes moved, so it is bound by
// the FP32 rate; at N = 15 (the temporal transform) it is bound by memory.
// A second instance with a narrow output tile (BN = 16) serves N <= 16 so
// that the temporal transforms do not spend 4x the work on padding.

#include <cuda_runtime.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
dft_matmul_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ wr, const float* __restrict__ wi,
                  float* __restrict__ yr, float* __restrict__ yi, int B, int N) {
  constexpr int TX = BN / TN;  // threads along output columns
  constexpr int TY = BM / TM;  // threads along output rows
  constexpr int NT = TX * TY;
  // +1 padding keeps the transposing stores below free of most bank conflicts
  __shared__ float sxr[BK][BM + 1], sxi[BK][BM + 1];
  __shared__ float swr[BK][BN + 1], swi[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long row0 = static_cast<long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  float accr[TM][TN], acci[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) accr[m][n] = acci[m][n] = 0.f;

  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, k = idx % BK;
      const long row = row0 + r;
      const int kk = k0 + k;
      const bool ok = row < B && kk < N;
      const long g = row * N + kk;
      sxr[k][r] = ok ? xr[g] : 0.f;
      sxi[k][r] = ok ? xi[g] : 0.f;
    }
    for (int idx = tid; idx < BN * BK; idx += NT) {
      const int j = idx / BK, k = idx % BK;
      const int col = col0 + j;
      const int kk = k0 + k;
      const bool ok = col < N && kk < N;
      const long g = static_cast<long>(col) * N + kk;
      swr[k][j] = ok ? wr[g] : 0.f;
      swi[k][j] = ok ? wi[g] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        ar[m] = sxr[k][ty + TY * m];
        ai[m] = sxi[k][ty + TY * m];
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        br[n] = swr[k][tx + TX * n];
        bi[n] = swi[k][tx + TX * n];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          accr[m][n] = fmaf(ar[m], br[n], accr[m][n]);
          accr[m][n] = fmaf(-ai[m], bi[n], accr[m][n]);
          acci[m][n] = fmaf(ar[m], bi[n], acci[m][n]);
          acci[m][n] = fmaf(ai[m], br[n], acci[m][n]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const long row = row0 + ty + TY * m;
    if (row >= B) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int col = col0 + tx + TX * n;
      if (col < N) {
        yr[row * N + col] = accr[m][n];
        yi[row * N + col] = acci[m][n];
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* xr, const float* xi, const float* wr, const float* wi,
            float* yr, float* yi, int B, int N, cudaStream_t stream) {
  constexpr int threads = (BM / TM) * (BN / TN);
  const dim3 grid((B + BM - 1) / BM, (N + BN - 1) / BN);
  dft_matmul_kernel<BM, BN, BK, TM, TN><<<grid, threads, 0, stream>>>(
      xr, xi, wr, wi, yr, yi, B, N);
}

}  // namespace

extern "C" int cinemri_dft_matmul(const float* xr, const float* xi,
                                  const float* wr, const float* wi,
                                  float* yr, float* yi, int B, int N,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 16) {
    launch<256, 16, 16, 16, 1>(xr, xi, wr, wi, yr, yi, B, N, s);
  } else {
    launch<64, 64, 16, 4, 4>(xr, xi, wr, wi, yr, yi, B, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
