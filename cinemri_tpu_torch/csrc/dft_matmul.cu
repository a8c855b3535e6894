// Complex DFT product along the middle axis of x, on planar (re, im) float32
// operands:
//
//   y[o, j, i] = Σ_k W[j, k] · x[o, k, i]      x, y: (O, N, I)   W: (N, N)
//
// so a transform along any axis of a contiguous tensor is a view, not a copy
// (ops/fft.py::_apply_dft). Replaces the Pallas kernel
// complex_dft_matmul_pallas (cinemri_tpu/ops/kernels/dft_pallas.py, body
// _kernel), which computes the I == 1 case on rows moved last.
//
// Arithmetic: the 4-multiplication complex product in full f32 on CUDA cores
// (FMA, no TF32), matching the JAX package's Precision.HIGHEST:
//   yr += wr·xr − wi·xi;   yi += wr·xi + wi·xr.
//
// What bounds it on the H100: at N = 200 (the image-axis transforms) 8·N
// FLOP per output against 16 bytes moved, so the FP32 rate; at N ≤ 16 (the
// temporal transforms) memory.
//
// Three instances:
// - I == 1: y = x · Wᵀ on contiguous rows, the block tile of cgemm_tile.cuh
//   with A = rows of x and B = W, both k-contiguous.
// - I > 1: W applied from the left to each (N, I) slab, computed transposed,
//   yᵀ = Xᵀ · Wᵀ: the rows of A are the columns c = o·I + i of x, staged as
//   they lie (column-contiguous, read coalesced along I, tiles running on
//   across slabs so that none is padded), and B = W as above. So both
//   instances give a thread the same 8 x 5 register tile (cgemm_tile.cuh).
//   Column tiles of 40 cover N = 200 with no padding; a smaller row tile
//   (3 x 5 a thread) when the large one would not give every SM two blocks
//   (the sens net's 2000 rows, its 10 slabs of 200 columns).
// - N ≤ 16: memory-bound; W (at most 16 x 16 complex) sits in shared memory
//   and x is read once, y written once. With I == 1 a block stages a flat
//   chunk of rows with float4 copies (rows of 15 floats are not 16-byte
//   aligned) and a thread transforms one row; with I > 1 a thread
//   transforms one column (o, i), its loads and stores coalesced along I.
// Rows that are not 16-byte aligned (N or I not a multiple of 4) take 4-byte
// copies in the tile engine.

#include "cgemm_tile.cuh"

namespace {

using cgemm::Lane;
using cgemm::Operand;

// The N > 16 instances, one kernel: C (M x N) = A · Wᵀ with B = W
// (k-contiguous) and M rows that are either
// - ROWS (I == 1): the rows of x, k-contiguous: A = x (O x N), y = x · Wᵀ;
// - slab columns (I > 1): the columns c = o·I + i of every slab, staged as
//   they lie (column-contiguous, across slabs): C = Xᵀ · Wᵀ = yᵀ.
// Blocks run over (row tile, column tile), the column tiles of a row tile
// next to each other so that its rows of A are read from device memory once.
template <class T, bool ROWS, int VEC>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ wr, const float* __restrict__ wi,
           float* __restrict__ yr, float* __restrict__ yi, long M, int N, int I, int n_tiles) {
  const Lane<T> lane(threadIdx.x);
  const long m0 = static_cast<long>(blockIdx.x / n_tiles) * T::BM;
  const int n0 = blockIdx.x % n_tiles * T::BN;
  const int rows = M - m0 < T::BM ? static_cast<int>(M - m0) : T::BM;
  const long slab = static_cast<long>(N) * I;
  const Operand a = ROWS ? Operand{xr + m0 * N, xi + m0 * N, N, rows}
                         : Operand{xr, xi, I, rows, m0, I, slab};
  const Operand b{wr + static_cast<long>(n0) * N, wi + static_cast<long>(n0) * N, N, N - n0};
  float cr[T::TM][T::TN], ci[T::TM][T::TN];
  cgemm::zero<T>(cr, ci);
  cgemm::block_mma<T, false, ROWS, true, VEC>(reinterpret_cast<float*>(cgemm::smem), a, b, N,
                                               threadIdx.x, lane, cr, ci);
  if constexpr (ROWS) {
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = lane.ty + T::TY * m;
      if (r >= rows) continue;
#pragma unroll
      for (int n = 0; n < T::TN; ++n) {
        const int j = n0 + lane.template col<true>(n);
        if (j < N) {
          yr[(m0 + r) * N + j] = cr[m][n];
          yi[(m0 + r) * N + j] = ci[m][n];
        }
      }
    }
  } else {
    // y[o, j, i] lies along i: the tile goes through shared memory (the ring,
    // drained) so that neighbouring threads store neighbouring columns
    constexpr int LDT = T::BM + 4;  // 4·tx + ty: the 32 lanes' writes on distinct banks
    static_assert(T::BN * LDT + 2 * T::BM <= T::STAGES * T::template stage_floats<false, false, true>(),
                  "the output tile and its column offsets fit the ring");
    float* const tile = reinterpret_cast<float*>(cgemm::smem);
    long* const offset = reinterpret_cast<long*>(tile + T::BN * LDT);
    for (int r = threadIdx.x; r < rows; r += T::THREADS) offset[r] = cgemm::column_offset(a, r);
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int m = 0; m < T::TM; ++m)
#pragma unroll
        for (int n = 0; n < T::TN; ++n)
          tile[lane.template col<true>(n) * LDT + lane.ty + T::TY * m] = part ? ci[m][n] : cr[m][n];
      __syncthreads();
      float* const y = part ? yi : yr;
      for (int e = threadIdx.x; e < T::BN * T::BM; e += T::THREADS) {
        const int j = e / T::BM, r = e % T::BM;
        if (r < rows && n0 + j < N) y[offset[r] + static_cast<long>(n0 + j) * I] = tile[j * LDT + r];
      }
      __syncthreads();
    }
  }
}

constexpr int SMALL_N = 16;         // the N <= 16 instance
constexpr int SMALL_THREADS = 128;  // rows (I == 1) or columns (I > 1) per block

__device__ __forceinline__ void load_w(float* swr, float* swi, const float* wr, const float* wi,
                                       int N) {
  for (int e = threadIdx.x; e < N * N; e += SMALL_THREADS) {
    swr[e] = wr[e];
    swi[e] = wi[e];
  }
}

// out = W · v for one N-vector, W in shared memory, v and out in registers.
__device__ __forceinline__ void small_dft(const float* swr, const float* swi, int N,
                                          float (&vr)[SMALL_N], float (&vi)[SMALL_N],
                                          float (&outr)[SMALL_N], float (&outi)[SMALL_N]) {
#pragma unroll
  for (int j = 0; j < SMALL_N; ++j) {
    float ar = 0.f, ai = 0.f;
    if (j < N) {
#pragma unroll
      for (int k = 0; k < SMALL_N; ++k) {
        if (k < N) {
          const float w_r = swr[j * N + k], w_i = swi[j * N + k];
          ar = fmaf(w_r, vr[k], ar);
          ar = fmaf(-w_i, vi[k], ar);
          ai = fmaf(w_r, vi[k], ai);
          ai = fmaf(w_i, vr[k], ai);
        }
      }
    }
    outr[j] = ar;
    outi[j] = ai;
  }
}

// Copy `count` floats between device and shared memory, as float4 where
// both ends are 16-byte aligned (the shared end always is).
__device__ __forceinline__ void flat_copy(float* dst, const float* src, int count, bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = count / 4;
    for (int e = threadIdx.x; e < n4; e += SMALL_THREADS)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
    done = 4 * n4;
  }
  for (int e = done + threadIdx.x; e < count; e += SMALL_THREADS) dst[e] = src[e];
}

// I == 1, N <= 16: one block transforms SMALL_THREADS consecutive rows.
__global__ void __launch_bounds__(SMALL_THREADS)
dft_small_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ wr, const float* __restrict__ wi,
                      float* __restrict__ yr, float* __restrict__ yi, int O, int N, int vec) {
  float* const swr = reinterpret_cast<float*>(cgemm::smem);
  float* const swi = swr + SMALL_N * SMALL_N;
  float* const sxr = swi + SMALL_N * SMALL_N;
  float* const sxi = sxr + SMALL_THREADS * SMALL_N;
  const long row0 = static_cast<long>(blockIdx.x) * SMALL_THREADS;
  const int rows = O - row0 < SMALL_THREADS ? static_cast<int>(O - row0) : SMALL_THREADS;
  const long e0 = row0 * N;
  load_w(swr, swi, wr, wi, N);
  flat_copy(sxr, xr + e0, rows * N, vec);
  flat_copy(sxi, xi + e0, rows * N, vec);
  __syncthreads();
  const int r = threadIdx.x;
  if (r < rows) {
    float vr[SMALL_N], vi[SMALL_N], outr[SMALL_N], outi[SMALL_N];
#pragma unroll
    for (int k = 0; k < SMALL_N; ++k) {
      vr[k] = k < N ? sxr[r * N + k] : 0.f;
      vi[k] = k < N ? sxi[r * N + k] : 0.f;
    }
    small_dft(swr, swi, N, vr, vi, outr, outi);
#pragma unroll
    for (int j = 0; j < SMALL_N; ++j) {
      if (j < N) {
        sxr[r * N + j] = outr[j];  // the thread's own row: read in full above
        sxi[r * N + j] = outi[j];
      }
    }
  }
  __syncthreads();
  flat_copy(yr + e0, sxr, rows * N, vec);
  flat_copy(yi + e0, sxi, rows * N, vec);
}

// I > 1, N <= 16: one thread transforms column (o, i) of slab o.
__global__ void __launch_bounds__(SMALL_THREADS)
dft_small_cols_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      const float* __restrict__ wr, const float* __restrict__ wi,
                      float* __restrict__ yr, float* __restrict__ yi, long O, int N, int I) {
  float* const swr = reinterpret_cast<float*>(cgemm::smem);
  float* const swi = swr + SMALL_N * SMALL_N;
  load_w(swr, swi, wr, wi, N);
  __syncthreads();
  const long t = static_cast<long>(blockIdx.x) * SMALL_THREADS + threadIdx.x;
  if (t >= O * I) return;
  const long base = t / I * N * I + t % I;
  float vr[SMALL_N], vi[SMALL_N], outr[SMALL_N], outi[SMALL_N];
#pragma unroll
  for (int k = 0; k < SMALL_N; ++k) {
    vr[k] = k < N ? xr[base + static_cast<long>(k) * I] : 0.f;
    vi[k] = k < N ? xi[base + static_cast<long>(k) * I] : 0.f;
  }
  small_dft(swr, swi, N, vr, vi, outr, outi);
#pragma unroll
  for (int j = 0; j < SMALL_N; ++j) {
    if (j < N) {
      yr[base + static_cast<long>(j) * I] = outr[j];
      yi[base + static_cast<long>(j) * I] = outi[j];
    }
  }
}

// Tiles (BM, BN, BK, TM, TN, STAGES, MINB, KU): 8 x (BM / TM) threads.
// Large: 8 x 5 complex outputs a thread (80 accumulators), k steps one at a
// time so that 128 registers hold it, 4 blocks an SM. Small, for grids the
// large tile would leave short of two blocks an SM: 3 x 5 outputs a thread.
using Large = cgemm::Tile<128, 40, 8, 8, 5, 3, 4, 1>;  // 128 threads
using Small = cgemm::Tile<48, 40, 8, 3, 5, 3, 4, 8>;   // 128 threads

template <class T, int VEC>
int launch_tiles(const float* xr, const float* xi, const float* wr, const float* wi, float* yr,
                 float* yi, int O, int N, int I, cudaStream_t s) {
  if (I == 1) {
    constexpr int smem = T::STAGES * T::template stage_floats<false, true, true>() * sizeof(float);
    const int n_tiles = (N + T::BN - 1) / T::BN;
    const dim3 grid(static_cast<unsigned>((O + T::BM - 1) / T::BM * n_tiles));
    return cgemm::launch<dft_kernel<T, true, VEC>>(grid, T::THREADS, smem, s, xr, xi, wr, wi, yr,
                                                   yi, static_cast<long>(O), N, I, n_tiles);
  }
  constexpr int smem = T::STAGES * T::template stage_floats<false, false, true>() * sizeof(float);
  const long columns = static_cast<long>(O) * I;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const dim3 grid(static_cast<unsigned>((columns + T::BM - 1) / T::BM * n_tiles));
  return cgemm::launch<dft_kernel<T, false, VEC>>(grid, T::THREADS, smem, s, xr, xi, wr, wi, yr,
                                                  yi, columns, N, I, n_tiles);
}

int launch_small(const float* xr, const float* xi, const float* wr, const float* wi, float* yr,
                 float* yi, int O, int N, int I, bool vec, cudaStream_t s) {
  constexpr int w_floats = 2 * SMALL_N * SMALL_N;
  if (I == 1) {
    constexpr int smem = (w_floats + 2 * SMALL_THREADS * SMALL_N) * sizeof(float);
    const dim3 grid((O + SMALL_THREADS - 1) / SMALL_THREADS);
    return cgemm::launch<dft_small_rows_kernel>(grid, SMALL_THREADS, smem, s, xr, xi, wr, wi, yr,
                         yi, O, N, static_cast<int>(vec));
  }
  const long columns = static_cast<long>(O) * I;
  const dim3 grid(static_cast<unsigned>((columns + SMALL_THREADS - 1) / SMALL_THREADS));
  return cgemm::launch<dft_small_cols_kernel>(grid, SMALL_THREADS,
                       static_cast<int>(w_floats * sizeof(float)), s, xr, xi, wr, wi, yr, yi,
                       static_cast<long>(O), N, I);
}

}  // namespace

extern "C" int cinemri_dft_matmul(const float* xr, const float* xi, const float* wr,
                                  const float* wi, float* yr, float* yi, int O, int N, int I,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = cgemm::aligned16(xr) && cgemm::aligned16(xi) && cgemm::aligned16(wr) &&
                       cgemm::aligned16(wi) && cgemm::aligned16(yr) && cgemm::aligned16(yi);
  if (N <= SMALL_N) return launch_small(xr, xi, wr, wi, yr, yi, O, N, I, aligned, s);
  if (!(aligned && N % 4 == 0 && (I == 1 || I % 4 == 0)))
    return launch_tiles<Small, 1>(xr, xi, wr, wi, yr, yi, O, N, I, s);
  // the large tile when it gives every SM at least two blocks
  const long rows = static_cast<long>(O) * I;
  const long large = (rows + Large::BM - 1) / Large::BM * ((N + Large::BN - 1) / Large::BN);
  return large >= 2L * cgemm::sm_count()
             ? launch_tiles<Large, 4>(xr, xi, wr, wi, yr, yi, O, N, I, s)
             : launch_tiles<Small, 4>(xr, xi, wr, wi, yr, yi, O, N, I, s);
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
