// Batched 2-D complex DFT of planes on planar (re, im) float32 operands.
//
//   Y[b] = W_h · X[b] · W_wᵀ       X, Y: (B, h, w)   W_h: (h, h)   W_w: (w, w)
//   Y[b, i, j] = Σ_l (Σ_k W_h[i, k] · X[b, k, l]) · W_w[j, l]
//
// Replaces the Pallas kernel fft2_plane_pallas (cinemri_tpu/ops/kernels/
// fft2_pallas.py, body _kernel). W_w is passed as it is (not transposed):
// the kernel right-multiplies by its transpose, as the Pallas wrapper does
// after transposing it on the host.
//
// Arithmetic: the 4-multiplication complex product in full f32 on CUDA
// cores (FMA, no TF32), matching the JAX kernel's Precision.HIGHEST:
//   A = W_h · X:    ar += whr·xr − whi·xi;   ai += whr·xi + whi·xr
//   Y = A · W_wᵀ:   yr += ar·wwr − ai·wwi;   yi += ar·wwi + ai·wwr
//
// What bounds it on the H100: 8·B·(h²w + hw²) FLOP against 16·B·h·w bytes
// of planes plus the matrices; at (150, 200, 200) 19.2 GFLOP against 48 MB,
// so the FP32 rate (0.29 ms at 67 TFLOP/s).
//
// Design. The Pallas program holds one whole plane, both DFT matrices and
// the intermediate W_h·X in VMEM (~2 MB). A 200 x 200 plane alone is 320 KB
// in re + im, more than a block's 227 KB of shared memory, so a block owns
// one strip of BM output rows of one plane:
// - phase 1 computes its strip of A = W_h[rows, :] · X[b] into shared
//   memory (BM x w complex, 53 KB at w = 200), tiled BN columns at a time,
//   with the W_h and X tiles of each BK-deep chunk staged in shared memory;
// - phase 2 multiplies the strip by W_wᵀ, staging W_w tiles the same way,
//   and writes Y.
// So the intermediate W_h·X stays on chip, as in the JAX kernel: only X, the
// matrices and Y move through device memory. A thread accumulates TM x TN
// complex outputs in registers; the grid runs over (plane, strip).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;         // output rows per block: one strip of a plane
constexpr int BN = 64;         // output columns per tile
constexpr int BK = 16;         // contraction chunk
constexpr int TM = 2, TN = 4;  // outputs per thread (rows ty + TY·m, columns tx + TX·n)
constexpr int TX = BN / TN;    // threads along columns
constexpr int TY = BM / TM;    // threads along rows
constexpr int NT = TX * TY;

// Row stride of the A strip in shared memory: w rounded up to the chunk
// depth (phase 2 reads whole chunks; the padding columns hold zeros), plus
// one so that the two rows a warp reads fall on different banks.
__host__ __device__ inline int strip_ld(int w) { return (w + BK - 1) / BK * BK + 1; }

__global__ void __launch_bounds__(NT)
fft2_plane_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ whr, const float* __restrict__ whi,
                  const float* __restrict__ wwr, const float* __restrict__ wwi,
                  float* __restrict__ yr, float* __restrict__ yi, int H, int W) {
  extern __shared__ float strip[];                    // A: re (BM x lda), then im
  __shared__ float sar[BK][BM + 1], sai[BK][BM + 1];  // W_h[rows, k-chunk], k-major
  __shared__ float sbr[BK][BN + 1], sbi[BK][BN + 1];  // X[k-chunk, cols] / W_w[cols, l-chunk]ᵀ

  const int lda = strip_ld(W);
  float* const as_r = strip;
  float* const as_i = strip + BM * lda;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long plane = static_cast<long>(blockIdx.x) * H * W;
  const int i0 = blockIdx.y * BM;
  const float* xrp = xr + plane;
  const float* xip = xi + plane;

  // zero the strip's padding columns [W, lda): phase 2 reads them
  for (int idx = tid; idx < BM * (lda - W); idx += NT) {
    const int r = idx / (lda - W), col = W + idx % (lda - W);
    as_r[r * lda + col] = 0.f;
    as_i[r * lda + col] = 0.f;
  }

  float accr[TM][TN], acci[TM][TN];

  // -- phase 1: A[r, :] = Σ_k W_h[i0 + r, k] · X[k, :] into shared memory ----
  for (int c0 = 0; c0 < W; c0 += BN) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) accr[m][n] = acci[m][n] = 0.f;

    for (int k0 = 0; k0 < H; k0 += BK) {
      for (int idx = tid; idx < BM * BK; idx += NT) {
        const int r = idx / BK, kk = idx % BK;
        const int i = i0 + r, k = k0 + kk;
        const bool ok = i < H && k < H;
        const long g = static_cast<long>(i) * H + k;
        sar[kk][r] = ok ? whr[g] : 0.f;
        sai[kk][r] = ok ? whi[g] : 0.f;
      }
      for (int idx = tid; idx < BK * BN; idx += NT) {
        const int kk = idx / BN, c = idx % BN;
        const int k = k0 + kk, col = c0 + c;
        const bool ok = k < H && col < W;
        const long g = static_cast<long>(k) * W + col;
        sbr[kk][c] = ok ? xrp[g] : 0.f;
        sbi[kk][c] = ok ? xip[g] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          a_r[m] = sar[kk][ty + TY * m];
          a_i[m] = sai[kk][ty + TY * m];
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          b_r[n] = sbr[kk][tx + TX * n];
          b_i[n] = sbi[kk][tx + TX * n];
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            accr[m][n] = fmaf(a_r[m], b_r[n], accr[m][n]);
            accr[m][n] = fmaf(-a_i[m], b_i[n], accr[m][n]);
            acci[m][n] = fmaf(a_r[m], b_i[n], acci[m][n]);
            acci[m][n] = fmaf(a_i[m], b_r[n], acci[m][n]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = ty + TY * m;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int col = c0 + tx + TX * n;
        if (col < W) {
          as_r[r * lda + col] = accr[m][n];
          as_i[r * lda + col] = acci[m][n];
        }
      }
    }
  }
  __syncthreads();

  // -- phase 2: Y[i0 + r, j] = Σ_l A[r, l] · W_w[j, l] ---------------------------
  for (int c0 = 0; c0 < W; c0 += BN) {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) accr[m][n] = acci[m][n] = 0.f;

    for (int l0 = 0; l0 < W; l0 += BK) {
      // neighbouring threads read neighbouring l of row j of W_w (coalesced)
      for (int idx = tid; idx < BN * BK; idx += NT) {
        const int c = idx / BK, ll = idx % BK;
        const int j = c0 + c, l = l0 + ll;
        const bool ok = j < W && l < W;
        const long g = static_cast<long>(j) * W + l;
        sbr[ll][c] = ok ? wwr[g] : 0.f;
        sbi[ll][c] = ok ? wwi[g] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ll = 0; ll < BK; ++ll) {
        float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          a_r[m] = as_r[(ty + TY * m) * lda + l0 + ll];
          a_i[m] = as_i[(ty + TY * m) * lda + l0 + ll];
        }
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          b_r[n] = sbr[ll][tx + TX * n];
          b_i[n] = sbi[ll][tx + TX * n];
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            accr[m][n] = fmaf(a_r[m], b_r[n], accr[m][n]);
            accr[m][n] = fmaf(-a_i[m], b_i[n], accr[m][n]);
            acci[m][n] = fmaf(a_r[m], b_i[n], acci[m][n]);
            acci[m][n] = fmaf(a_i[m], b_r[n], acci[m][n]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = i0 + ty + TY * m;
      if (i >= H) continue;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int j = c0 + tx + TX * n;
        if (j < W) {
          const long g = plane + static_cast<long>(i) * W + j;
          yr[g] = accr[m][n];
          yi[g] = acci[m][n];
        }
      }
    }
  }
}

}  // namespace

extern "C" int cinemri_fft2_plane(const float* xr, const float* xi, const float* whr,
                                  const float* whi, const float* wwr, const float* wwi,
                                  float* yr, float* yi, int b, int h, int w, void* stream) {
  const int smem = 2 * BM * strip_ld(w) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fft2_plane_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, (h + BM - 1) / BM);
  fft2_plane_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, whr, whi, wwr, wwi, yr, yi, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
