// Block-tile complex matrix product on planar (re, im) float32 operands,
// shared by csrc/dft_matmul.cu and csrc/fft2_plane.cu:
//
//   C (BM x BN) += A (BM x K) · B (K x BN)
//
// Arithmetic: the 4-multiplication complex product in full f32 on the CUDA
// cores (FMA, no TF32), the port's 'highest' precision (the JAX package's
// Precision.HIGHEST):
//   cr += ar·br − ai·bi;   ci += ar·bi + ai·br
// The tensor cores are not used: TF32 keeps 10 mantissa bits, and the
// 3xTF32 split that recovers f32 accuracy on them is the route for a
// 'high' precision mode of the DFT, not built yet.
//
// Operands. Each is k-contiguous (row r at a[r·ld + k]: W, the rows of x,
// fft2_plane's strip held in shared memory) or column-contiguous (column c
// at a[k·ld + c]: the (N, I) slabs of x, whose columns may run on across
// slabs). A DFT along any axis of a contiguous tensor is one of these.
//
// Staging. Each BK-deep chunk of A and B goes from device memory into a
// ring of STAGES buffers in shared memory by cp.async (16-byte copies where
// rows are 16-byte aligned, else 4-byte ones), laid out as in device
// memory, so there are no transposing stores. The copies of chunk
// c + STAGES − 1 are issued before the FMAs of chunk c, so loads overlap
// compute, with one __syncthreads per chunk. Rows, columns and k past the
// matrix are zero-filled by the copies, so the FMA loop has no masks.
//
// Register tile. The threads form 8 columns (tx) x TY rows (ty) x G column
// groups of 8·TN columns; a thread owns TM x TN complex outputs (Lane). Per
// k it reads TM complex A values and TN complex B values from shared memory
// and does 4·TM·TN FMAs. What bounds the tile on the H100 is the words a
// thread reads from shared memory per FMA, 2·(TM + TN) / (4·TM·TN): shared
// memory serves 32 words a clock to an SM that does 128 FMAs, so 0.25 is the
// most it can sustain; an 8 x 5 tile reads 0.1625 (65% of that), a 5 x 5
// tile 0.2 (80%). The 80 accumulators of an 8 x 5 tile fit 128 registers when
// the k steps are not unrolled (Tile::KU = 1). Bank conflicts: a warp is 8
// columns x 4 rows; its A reads are 4 words (one per row, broadcast), its B
// reads 8 consecutive words (or float4 runs of 32) of a column-contiguous
// tile, or 8 k-contiguous rows whose stride, BK + 4 ≡ 4 (mod 8) words, puts
// them on distinct banks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cgemm {

// Dynamic shared memory of every kernel that includes this header.
extern __shared__ float4 smem[];

// -- PTX primitives: asynchronous copies into shared memory ------------------
// 16-byte copy that reads `bytes` (0, 4, 8, 12 or 16) and zero-fills the rest.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
// 4-byte copy (bytes 0 or 4), for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// -- end PTX primitives -------------------------------------------------------

// MINB: blocks each SM should hold at once (__launch_bounds__), which caps
// the registers a thread may take. KU: k steps unrolled together; the
// compiler loads the operands of all of them ahead, so a large register
// tile needs KU = 1 to fit.
template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_, int MINB_ = 1, int KU_ = 1>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr int MINB = MINB_, KU = KU_;
  static constexpr int TX = 8;          // threads along the columns of a group
  static constexpr int TY = BM / TM;    // threads along the rows
  static constexpr int GN = TX * TN;    // columns of one group
  static constexpr int G = BN / GN;     // column groups
  static constexpr int THREADS = TX * TY * G;
  static constexpr int LDK = BK + 4;    // row stride of a staged k-contiguous tile
  static_assert(BM == TY * TM && BN == G * GN, "the threads must cover the tile");
  static_assert(BK % 8 == 0, "staged k-contiguous rows must fall on distinct banks");

  // floats of one ring stage: the A tile (unless resident) and the B tile, re then im
  template <bool A_RESIDENT, bool A_KC, bool B_KC>
  __host__ __device__ static constexpr int stage_floats() {
    return 2 * ((A_RESIDENT ? 0 : BM * (A_KC ? LDK : BK)) + (B_KC ? BN * LDK : BK * BN));
  }
};

// Where a thread's register tile sits: rows ty + TY·m; columns, within its
// group's GN = 8·TN, tx + 8·n when B is k-contiguous (8 lanes read 8 B rows),
// and when B is column-contiguous, in runs of 4 (32·(n / 4) + 4·tx + n % 4:
// 8 lanes read 32 consecutive words as float4) and, for TN % 4 == 1, a last
// column 32·(TN / 4) + tx.
template <class T>
struct Lane {
  int ty, tx, c0;
  __device__ explicit Lane(int tid)
      : ty((tid / T::TX) % T::TY), tx(tid % T::TX), c0(tid / (T::TX * T::TY) * T::GN) {}
  template <bool B_KC>
  __device__ int col(int n) const {
    if constexpr (B_KC) {
      return c0 + tx + T::TX * n;
    } else {
      return c0 + (n < T::TN / 4 * 4 ? 4 * T::TX * (n / 4) + 4 * tx + n % 4
                                      : 4 * T::TX * (T::TN / 4) + tx);
    }
  }
};

// A tile's origin in device memory (or, for a resident A, in shared memory):
// row stride and the valid rows (k-contiguous) or columns (column-contiguous)
// from the origin. A column-contiguous operand may run across slabs: with
// `width` > 0, its column col0 + c lies in slab (col0 + c) / width, `slab`
// floats apart, at column (col0 + c) % width.
struct Operand {
  const float* re;
  const float* im;
  long ld;
  int valid;
  long col0 = 0;
  int width = 0;
  long slab = 0;
};

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  if constexpr (VEC == 4) {
    cp_async16(dst, src, bytes);
  } else {
    cp_async4(dst, src, bytes);
  }
}

// Rows [0, R) x k [k0, k0 + BK) of a k-contiguous matrix into s (row stride
// BK + 4); zero past `rows` and `K`.
template <int R, int BK, int NT, int VEC>
__device__ __forceinline__ void stage_kc(float* s, const float* g, long ld, int rows, int k0, int K,
                                         int tid) {
  constexpr int CPR = BK / VEC;  // copies per row
  for (int idx = tid; idx < R * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR * VEC, k = k0 + c;
    const int bytes = (r < rows && k < K) ? 4 * (K - k < VEC ? K - k : VEC) : 0;
    cp_async<VEC>(s + r * (BK + 4) + c, bytes ? g + r * ld + k : g, bytes);
  }
}

// Offset in device memory of column col0 + c of a column-contiguous B.
__device__ __forceinline__ long column_offset(const Operand& b, int c) {
  if (b.width == 0) return b.col0 + c;
  const long gc = b.col0 + c;
  const int slab = static_cast<int>(gc / b.width);
  return slab * b.slab + static_cast<int>(gc - static_cast<long>(slab) * b.width);
}

// k [k0, k0 + BK) x columns [0, C) of a column-contiguous matrix into s (row
// stride C); zero past `cols` and `K`. With slabs (Operand::width), a copy of
// VEC columns never crosses one: width % VEC == 0. When the block's threads
// are a multiple of a row's copies, each thread copies one column at every
// k, and finds its place once.
template <int BK, int C, int NT, int VEC>
__device__ __forceinline__ void stage_nc(float* s, const float* g, const Operand& b, int k0, int K,
                                         int tid) {
  constexpr int CPR = C / VEC;
  if constexpr (NT % CPR == 0) {
    const int c = tid % CPR * VEC;
    const long col = c < b.valid ? column_offset(b, c) : 0;
    const int cbytes = c < b.valid ? 4 * (b.valid - c < VEC ? b.valid - c : VEC) : 0;
#pragma unroll
    for (int kk = tid / CPR; kk < BK; kk += NT / CPR) {
      const int k = k0 + kk;
      const int bytes = k < K ? cbytes : 0;
      cp_async<VEC>(s + kk * C + c, bytes ? g + col + static_cast<long>(k) * b.ld : g, bytes);
    }
  } else {
    for (int idx = tid; idx < BK * CPR; idx += NT) {
      const int kk = idx / CPR, c = idx % CPR * VEC, k = k0 + kk;
      const int bytes = (k < K && c < b.valid) ? 4 * (b.valid - c < VEC ? b.valid - c : VEC) : 0;
      cp_async<VEC>(s + kk * C + c,
                    bytes ? g + column_offset(b, c) + static_cast<long>(k) * b.ld : g, bytes);
    }
  }
}

// acc += A[rows, k0 : k0 + BK] · B[k0 : k0 + BK, cols] on one staged chunk,
// one k at a time: a thread holds 2·TM + 2·TN operand registers beside its
// 4·TM·TN accumulators. A and a k-contiguous B are read a word at a time (a
// float4 over 4 k would hold 8·TM registers: the register tile would not
// fit); a column-contiguous B as float4 runs along its columns.
template <class T, bool A_KC, bool B_KC>
__device__ __forceinline__ void mma_chunk(const float* __restrict__ ar, const float* __restrict__ ai,
                                          int lda, const float* __restrict__ br,
                                          const float* __restrict__ bi, const Lane<T>& lane,
                                          float (&cr)[T::TM][T::TN], float (&ci)[T::TM][T::TN]) {
  static_assert(B_KC || T::TN % 4 <= 1, "a column-contiguous B takes runs of 4 columns (+ 1)");
  static_assert(T::BK % T::KU == 0, "k steps are unrolled KU at a time");
#pragma unroll 1
  for (int k0 = 0; k0 < T::BK; k0 += T::KU)
#pragma unroll
  for (int kk = 0; kk < T::KU; ++kk) {
    const int k = k0 + kk;
    float a_r[T::TM], a_i[T::TM], b_r[T::TN], b_i[T::TN];
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int off = A_KC ? (lane.ty + T::TY * m) * lda + k : k * lda + lane.ty + T::TY * m;
      a_r[m] = ar[off];
      a_i[m] = ai[off];
    }
    if constexpr (B_KC) {
#pragma unroll
      for (int n = 0; n < T::TN; ++n) {
        b_r[n] = br[lane.template col<true>(n) * T::LDK + k];
        b_i[n] = bi[lane.template col<true>(n) * T::LDK + k];
      }
    } else {
      const int row = k * T::BN + lane.c0;
#pragma unroll
      for (int n4 = 0; n4 < T::TN / 4; ++n4) {
        const int off = row + 4 * T::TX * n4 + 4 * lane.tx;
        const float4 vr = *reinterpret_cast<const float4*>(br + off);
        const float4 vi = *reinterpret_cast<const float4*>(bi + off);
        b_r[4 * n4] = vr.x, b_r[4 * n4 + 1] = vr.y, b_r[4 * n4 + 2] = vr.z, b_r[4 * n4 + 3] = vr.w;
        b_i[4 * n4] = vi.x, b_i[4 * n4 + 1] = vi.y, b_i[4 * n4 + 2] = vi.z, b_i[4 * n4 + 3] = vi.w;
      }
      if constexpr (T::TN % 4 == 1) {
        b_r[T::TN - 1] = br[row + 4 * T::TX * (T::TN / 4) + lane.tx];
        b_i[T::TN - 1] = bi[row + 4 * T::TX * (T::TN / 4) + lane.tx];
      }
    }
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
#pragma unroll
      for (int n = 0; n < T::TN; ++n) {
        cr[m][n] = fmaf(a_r[m], b_r[n], cr[m][n]);
        cr[m][n] = fmaf(-a_i[m], b_i[n], cr[m][n]);
        ci[m][n] = fmaf(a_r[m], b_i[n], ci[m][n]);
        ci[m][n] = fmaf(a_i[m], b_r[n], ci[m][n]);
      }
    }
  }
}

template <class T>
__device__ __forceinline__ void zero(float (&cr)[T::TM][T::TN], float (&ci)[T::TM][T::TN]) {
#pragma unroll
  for (int m = 0; m < T::TM; ++m)
#pragma unroll
    for (int n = 0; n < T::TN; ++n) cr[m][n] = ci[m][n] = 0.f;
}

// acc += A (BM x K) · B (K x BN) over the whole contraction, chunk by chunk
// through the cp.async ring. A is k-contiguous (A_KC) or column-contiguous
// like B's columns (then its rows are columns of a matrix, slabs allowed).
// With A_RESIDENT, a k-contiguous A is read in place from shared memory (its
// columns zero up to K rounded up to BK); else it is staged like B. Ends with
// the ring drained and the block synchronised, so the caller may reuse it.
template <class T, bool A_RESIDENT, bool A_KC, bool B_KC, int VEC>
__device__ __forceinline__ void block_mma(float* ring, const Operand& a, const Operand& b, int K,
                                          int tid, const Lane<T>& lane, float (&cr)[T::TM][T::TN],
                                          float (&ci)[T::TM][T::TN]) {
  static_assert(A_KC || !A_RESIDENT, "a resident A is k-contiguous");
  constexpr int AF = A_RESIDENT ? 0 : T::BM * (A_KC ? T::LDK : T::BK);
  constexpr int BF = B_KC ? T::BN * T::LDK : T::BK * T::BN;
  constexpr int SF = 2 * (AF + BF);
  const int nk = (K + T::BK - 1) / T::BK;
  auto load = [&](int chunk) {
    float* s = ring + (chunk % T::STAGES) * SF;
    const int k0 = chunk * T::BK;
    if constexpr (!A_RESIDENT && A_KC) {
      stage_kc<T::BM, T::BK, T::THREADS, VEC>(s, a.re, a.ld, a.valid, k0, K, tid);
      stage_kc<T::BM, T::BK, T::THREADS, VEC>(s + AF, a.im, a.ld, a.valid, k0, K, tid);
    } else if constexpr (!A_RESIDENT) {
      stage_nc<T::BK, T::BM, T::THREADS, VEC>(s, a.re, a, k0, K, tid);
      stage_nc<T::BK, T::BM, T::THREADS, VEC>(s + AF, a.im, a, k0, K, tid);
    }
    if constexpr (B_KC) {
      stage_kc<T::BN, T::BK, T::THREADS, VEC>(s + 2 * AF, b.re, b.ld, b.valid, k0, K, tid);
      stage_kc<T::BN, T::BK, T::THREADS, VEC>(s + 2 * AF + BF, b.im, b.ld, b.valid, k0, K, tid);
    } else {
      stage_nc<T::BK, T::BN, T::THREADS, VEC>(s + 2 * AF, b.re, b, k0, K, tid);
      stage_nc<T::BK, T::BN, T::THREADS, VEC>(s + 2 * AF + BF, b.im, b, k0, K, tid);
    }
  };
#pragma unroll
  for (int c = 0; c < T::STAGES - 1; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<T::STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();                 // everyone's have, and chunk c − 1 is consumed
    if (c + T::STAGES - 1 < nk) load(c + T::STAGES - 1);
    cp_async_commit();
    const float* s = ring + (c % T::STAGES) * SF;
    if constexpr (A_RESIDENT) {
      mma_chunk<T, true, B_KC>(a.re + c * T::BK, a.im + c * T::BK, static_cast<int>(a.ld), s,
                               s + BF, lane, cr, ci);
    } else {
      mma_chunk<T, A_KC, B_KC>(s, s + AF, A_KC ? T::LDK : T::BM, s + 2 * AF, s + 2 * AF + BF,
                               lane, cr, ci);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Launch `Kernel` with `smem_bytes` of dynamic shared memory, raising the
// kernel's limit first when that passes 48 KB (once per kernel and size, so
// the launch stays capturable in a CUDA graph); returns the cudaError_t.
template <auto Kernel, class... Args>
int launch(dim3 grid, int threads, int smem_bytes, cudaStream_t stream, Args... args) {
  static int allowed = 48 * 1024;
  if (smem_bytes > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem_bytes;
  }
  Kernel<<<grid, threads, smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Streaming multiprocessors of the current device (read once).
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace cgemm
