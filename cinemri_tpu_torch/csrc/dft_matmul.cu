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
// Arithmetic, by the launch's mode:
// - 0, 'highest' (the default): the 4-multiplication complex product in full
//   f32 on CUDA cores (FMA, no TF32), the JAX package's Precision.HIGHEST:
//     yr += wr·xr − wi·xi;   yi += wr·xi + wi·xr;
// - 1, 'high': 3xTF32 on the tensor cores, Precision.HIGH's counterpart;
// - 2, 'default': 1xTF32 on the tensor cores, Precision.DEFAULT's.
// The two TF32 modes run N > 16 on the Hopper tile of wgmma_tf32.cuh
// (wgmma m64n80k8 on operands rounded once while staging; at 'default' with
// the 64 rows of A resident and every column run over them, else streaming
// 128 x 40 or 64 x 40 tiles) in both instances below; shapes it cannot take
// (rows not 16-byte aligned, N or I not a multiple of 4) on the mma.sync tile
// of cgemm_tf32.cuh (64 x 40, 4-byte copies). N <= 16 takes the FP32 small
// kernel in every mode: it is bound by memory, so the tensor cores would buy
// no time, and it stays more exact than the mode asks.
//
// What bounds it on the H100: at N = 200 (the image-axis transforms) 8·N
// FLOP per output against 16 bytes moved, so the FP32 rate at 'highest' and
// memory at 'default' (the TF32 rate at 'high'); at N ≤ 16 (the temporal
// transforms) memory.
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

#include "cgemm_tf32.cuh"
#include "wgmma_tf32.cuh"

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
// The slab instance is the engine's slab_tile (cgemm_tile.cuh), shared with
// the normal apply's per-frame contractions.
template <class T, bool ROWS, int VEC>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
dft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
           const float* __restrict__ wr, const float* __restrict__ wi,
           float* __restrict__ yr, float* __restrict__ yi, long M, int N, int I, int n_tiles) {
  const long m0 = static_cast<long>(blockIdx.x / n_tiles) * T::BM;
  const int n0 = blockIdx.x % n_tiles * T::BN;
  const int rows = M - m0 < T::BM ? static_cast<int>(M - m0) : T::BM;
  if constexpr (!ROWS) {
    cgemm::slab_tile<T, VEC, true, false>(xr, xi, wr, wi, yr, yi, m0, rows, n0, N, I);
  } else {
    const Lane<T> lane(threadIdx.x);
    const Operand a{xr + m0 * N, xi + m0 * N, N, rows};
    const Operand b{wr + static_cast<long>(n0) * N, wi + static_cast<long>(n0) * N, N, N - n0};
    float cr[T::TM][T::TN], ci[T::TM][T::TN];
    cgemm::zero<T>(cr, ci);
    cgemm::block_mma<T, false, true, true, VEC>(reinterpret_cast<float*>(cgemm::smem), a, b, N,
                                                 threadIdx.x, lane, cr, ci);
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

// The TF32 modes: the instances of dft_kernel on the tensor-core tile.
template <class T, bool ROWS, int VEC, int PASSES>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
dft_kernel_tf32(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wr, const float* __restrict__ wi,
                float* __restrict__ yr, float* __restrict__ yi, long M, int N, int I,
                int n_tiles) {
  const long m0 = static_cast<long>(blockIdx.x / n_tiles) * T::BM;
  const int n0 = blockIdx.x % n_tiles * T::BN;
  const int rows = M - m0 < T::BM ? static_cast<int>(M - m0) : T::BM;
  if constexpr (ROWS) {
    tf32::rows_tile<T, VEC, PASSES>(xr, xi, wr, wi, yr, yi, m0, rows, n0, N);
  } else {
    tf32::slab_tile<T, VEC, true, false, PASSES>(xr, xi, wr, wi, yr, yi, m0, rows, n0, N, I);
  }
}

// The TF32 modes on the Hopper tile: both instances, the rows of A from
// x's rows (ROWS) or its slabs' columns (SLAB).
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1) dft_wgmma_kernel(const wgmma::Problem p) {
  wgmma::run<T>(p);
}

// 'default' with A resident in shared memory (N ≤ 224)
template <class R>
__global__ void __launch_bounds__(R::THREADS, 1) dft_wgmma_resident_kernel(const wgmma::Problem p) {
  wgmma::run_resident<R>(p);
}

using cgemm::Large;
using cgemm::Small;

// One launch of a tile kernel over M rows (I == 1) or slab columns (I > 1).
template <class T, auto RowsKernel, auto SlabKernel>
int launch_grid(const float* xr, const float* xi, const float* wr, const float* wi, float* yr,
                float* yi, int O, int N, int I, cudaStream_t s) {
  const int n_tiles = (N + T::BN - 1) / T::BN;
  if (I == 1) {
    constexpr int smem = T::STAGES * T::template stage_floats<false, true, true>() * sizeof(float);
    const dim3 grid(static_cast<unsigned>((O + T::BM - 1) / T::BM * n_tiles));
    return cgemm::launch<RowsKernel>(grid, T::THREADS, smem, s, xr, xi, wr, wi, yr, yi,
                                     static_cast<long>(O), N, I, n_tiles);
  }
  constexpr int smem = T::STAGES * T::template stage_floats<false, false, true>() * sizeof(float);
  const long columns = static_cast<long>(O) * I;
  const dim3 grid(static_cast<unsigned>((columns + T::BM - 1) / T::BM * n_tiles));
  return cgemm::launch<SlabKernel>(grid, T::THREADS, smem, s, xr, xi, wr, wi, yr, yi, columns, N,
                                   I, n_tiles);
}

template <class T, int VEC>
int launch_tiles(const float* xr, const float* xi, const float* wr, const float* wi, float* yr,
                 float* yi, int O, int N, int I, cudaStream_t s) {
  return launch_grid<T, dft_kernel<T, true, VEC>, dft_kernel<T, false, VEC>>(xr, xi, wr, wi, yr,
                                                                          yi, O, N, I, s);
}

// One instance on the Hopper tile: at 'default' A resident when its 64-row
// tiles fill the card (N <= 224); else the streaming tile, 128 rows when
// they fill it, 64 rows with a deep ring when they do not.
template <int PASSES, wgmma::Source SRC>
int launch_wgmma(const wgmma::Problem& p, cudaStream_t s) {
  using Wide = wgmma::Wide<PASSES, SRC>;
  using Narrow = wgmma::Narrow<PASSES, SRC>;
  if constexpr (PASSES == 1) {
    using R = wgmma::Resident<SRC>;
    if (wgmma::resident_fills<R>(p.M, p.N, 1))
      return wgmma::launch_resident<R, dft_wgmma_resident_kernel<R>>(p, s);
  }
  return wgmma::wide_fills(p.M, p.N, 1) ? wgmma::launch<Wide, dft_wgmma_kernel<Wide>>(p, s)
                                        : wgmma::launch<Narrow, dft_wgmma_kernel<Narrow>>(p, s);
}

// The TF32 modes at N > 16: the Hopper tile, or the mma.sync tile with 4-byte
// copies for rows that are not 16-byte aligned.
template <int PASSES>
int launch_tf32(const float* xr, const float* xi, const float* wr, const float* wi, float* yr,
                float* yi, int O, int N, int I, bool aligned, cudaStream_t s) {
  using TS = tf32::Small;
  if (!(aligned && N % 4 == 0 && (I == 1 || I % 4 == 0)))
    return launch_grid<TS, dft_kernel_tf32<TS, true, 1, PASSES>,
                       dft_kernel_tf32<TS, false, 1, PASSES>>(xr, xi, wr, wi, yr, yi, O, N, I, s);
  const wgmma::Problem p{xr, xi, nullptr, nullptr, wr, wi, yr, yi, static_cast<long>(O) * I,
                         N, I, 1, 1, 1};
  return I == 1 ? launch_wgmma<PASSES, wgmma::ROWS>(p, s) : launch_wgmma<PASSES, wgmma::SLAB>(p, s);
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

// mode: 0 'highest', 1 'high', 2 'default' (module comment)
extern "C" int cinemri_dft_matmul(const float* xr, const float* xi, const float* wr,
                                  const float* wi, float* yr, float* yi, int O, int N, int I,
                                  int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = cgemm::aligned16(xr) && cgemm::aligned16(xi) && cgemm::aligned16(wr) &&
                       cgemm::aligned16(wi) && cgemm::aligned16(yr) && cgemm::aligned16(yi);
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= SMALL_N) return launch_small(xr, xi, wr, wi, yr, yi, O, N, I, aligned, s);
  if (mode == 1) return launch_tf32<3>(xr, xi, wr, wi, yr, yi, O, N, I, aligned, s);
  if (mode == 2) return launch_tf32<1>(xr, xi, wr, wi, yr, yi, O, N, I, aligned, s);
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
