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
// cores (FMA, no TF32), matching the JAX kernel's Precision.HIGHEST, through
// the block tile of cgemm_tile.cuh:
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
// one strip of 40 output rows of one plane (5 strips at h = 200, no padding):
// - phase 1 computes its strip of A = W_h[rows, :] · X[b] into shared
//   memory (40 x w complex, 66.5 KB at w = 200), in column tiles of 200,
//   with the W_h (k-contiguous) and X (column-contiguous) chunks streamed
//   through the tile engine's cp.async ring (cgemm_tile.cuh);
// - phase 2 multiplies the strip, read in place, by W_wᵀ, with the W_w
//   chunks streamed the same way, and writes Y.
// So the intermediate W_h·X stays on chip, as in the JAX kernel: only X, the
// matrices and Y move through device memory. The strips of a plane are
// neighbours in the grid, so X is read from device memory about once.

#include "cgemm_tile.cuh"

namespace {

using cgemm::Lane;
using cgemm::Operand;

// 320 threads (5 column groups of 8 x 8) each own 5 x 5 complex outputs in
// both phases; 16-deep chunks, k steps unrolled two at a time (unrolling
// more of them spills), two ring stages.
using Strip = cgemm::Tile<40, 200, 16, 5, 5, 2, 1, 2>;
constexpr int STRIP = Strip::BM;  // output rows of a block

// Row stride of the strip in shared memory: w rounded up to the chunk depth
// (phase 2 reads whole chunks; the padding columns hold zeros).
__host__ __device__ inline int strip_ld(int w) { return (w + Strip::BK - 1) / Strip::BK * Strip::BK; }

constexpr int RING_FLOATS =
    Strip::STAGES * (Strip::stage_floats<false, true, false>() > Strip::stage_floats<true, true, true>()
                         ? Strip::stage_floats<false, true, false>()
                         : Strip::stage_floats<true, true, true>());

template <int VEC>
__global__ void __launch_bounds__(Strip::THREADS, Strip::MINB)
fft2_plane_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ whr, const float* __restrict__ whi,
                  const float* __restrict__ wwr, const float* __restrict__ wwi,
                  float* __restrict__ yr, float* __restrict__ yi, int H, int W) {
  using T = Strip;
  const int lds = strip_ld(W);
  float* const as_r = reinterpret_cast<float*>(cgemm::smem);  // A strip: re (STRIP x lds), then im
  float* const as_i = as_r + STRIP * lds;
  float* const ring = as_i + STRIP * lds;
  const int tid = threadIdx.x;
  const Lane<T> lane(tid);
  const long plane = static_cast<long>(blockIdx.y) * H * W;
  const int i0 = blockIdx.x * STRIP;
  const int rows = H - i0 < STRIP ? H - i0 : STRIP;

  // zero the strip's padding columns [W, lds): phase 2 reads them
  for (int e = tid; e < STRIP * (lds - W); e += T::THREADS) {
    const int r = e / (lds - W), col = W + e % (lds - W);
    as_r[r * lds + col] = 0.f;
    as_i[r * lds + col] = 0.f;
  }

  float cr[T::TM][T::TN], ci[T::TM][T::TN];

  // -- phase 1: A[r, :] = Σ_k W_h[i0 + r, k] · X[k, :] into shared memory ----
  const Operand wh{whr + static_cast<long>(i0) * H, whi + static_cast<long>(i0) * H, H, rows};
  for (int c0 = 0; c0 < W; c0 += T::BN) {
    cgemm::zero<T>(cr, ci);
    const Operand x{xr + plane, xi + plane, W, W - c0, c0};
    cgemm::block_mma<T, false, true, false, VEC>(ring, wh, x, H, tid, lane, cr, ci);
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = lane.ty + T::TY * m;  // rows past H hold zeros (zero-filled W_h rows)
#pragma unroll
      for (int n = 0; n < T::TN; ++n) {
        const int col = c0 + lane.template col<false>(n);
        if (col < W) {
          as_r[r * lds + col] = cr[m][n];
          as_i[r * lds + col] = ci[m][n];
        }
      }
    }
  }
  __syncthreads();

  // -- phase 2: Y[i0 + r, j] = Σ_l A[r, l] · W_w[j, l] ---------------------------
  const Operand a{as_r, as_i, lds, STRIP};
  for (int j0 = 0; j0 < W; j0 += T::BN) {
    cgemm::zero<T>(cr, ci);
    const Operand ww{wwr + static_cast<long>(j0) * W, wwi + static_cast<long>(j0) * W, W, W - j0};
    cgemm::block_mma<T, true, true, true, VEC>(ring, a, ww, W, tid, lane, cr, ci);
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = lane.ty + T::TY * m;
      if (r >= rows) continue;
#pragma unroll
      for (int n = 0; n < T::TN; ++n) {
        const int j = j0 + lane.template col<true>(n);
        if (j < W) {
          const long g = plane + static_cast<long>(i0 + r) * W + j;
          yr[g] = cr[m][n];
          yi[g] = ci[m][n];
        }
      }
    }
  }
}

template <int VEC>
int launch(const float* xr, const float* xi, const float* whr, const float* whi,
           const float* wwr, const float* wwi, float* yr, float* yi, int b, int h, int w,
           cudaStream_t s) {
  const int smem = static_cast<int>((2 * STRIP * strip_ld(w) + RING_FLOATS) * sizeof(float));
  const dim3 grid((h + STRIP - 1) / STRIP, b);  // a plane's strips side by side
  return cgemm::launch<fft2_plane_kernel<VEC>>(grid, Strip::THREADS, smem, s, xr, xi, whr, whi,
                                               wwr, wwi, yr, yi, h, w);
}

}  // namespace

extern "C" int cinemri_fft2_plane(const float* xr, const float* xi, const float* whr,
                                  const float* whi, const float* wwr, const float* wwi,
                                  float* yr, float* yi, int b, int h, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = h % 4 == 0 && w % 4 == 0 && cgemm::aligned16(xr) && cgemm::aligned16(xi) &&
                   cgemm::aligned16(whr) && cgemm::aligned16(whi) && cgemm::aligned16(wwr) &&
                   cgemm::aligned16(wwi);
  return vec ? launch<4>(xr, xi, whr, whi, wwr, wwi, yr, yi, b, h, w, s)
             : launch<1>(xr, xi, whr, whi, wwr, wwi, yr, yi, b, h, w, s);
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
