// Block-tile complex matrix product on the tensor cores in TF32, the
// 'high' (3 passes) and 'default' (1 pass) precisions of csrc/dft_matmul.cu
// and of the contractions of csrc/normal_apply*.cu:
//
//   C (BM x BN) += A (BM x K) · B (K x BN)        planar (re, im) float32
//
// Counterpart of the JAX package's Precision.HIGH / DEFAULT on the TPU's
// matrix unit (3 bf16 passes / 1); here the unit is the H100's TF32 tensor
// core, 10 mantissa bits a pass:
// - 'default' (PASSES = 1): a·b ≈ tf32(a)·tf32(b);
// - 'high' (PASSES = 3), 3xTF32: a = a_hi + a_lo with a_hi = tf32(a),
//   a_lo = tf32(a − a_hi), and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
//   (the small terms first), all into one f32 accumulator. a_hi + a_lo holds
//   a to 2⁻²² relative; the dropped a_lo·b_lo is below that.
// tf32(v) is cvt.rna.tf32.f32: round half away from zero to 10 mantissa
// bits. Products of tf32 values are exact in f32, so a plain version that
// rounds the operands the same way and takes the same partial products in
// f32 (ops/kernels/precision.py) differs from this tile only by summation
// order. The complex product takes 4 real products (not Gauss's 3, whose
// cancellation would cost bits at 10-bit operands):
//   cr += ar·br + ai·(−bi);   ci += ar·bi + ai·br
// with the sign flips on the tf32 bit patterns (exact). CONJ_B reads B as
// conj of what is stored: cr += ar·br + ai·bi; ci += ar·(−bi) + ai·br.
//
// Operands and staging are csrc/cgemm_tile.cuh's: each BK = 8 deep chunk of A
// and B goes through the same cp.async ring in the same layouts
// (k-contiguous rows at stride BK + 4, or column-contiguous slabs, CONJ_B
// for Kᴴ read in place), so the DFT's (O, N, I) routes and the normal
// apply's coil-stacked contraction keep their shapes. One chunk is one
// k-step of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//
// Warp tile. 4 warps; warp w owns rows [w·BM/4, (w + 1)·BM/4) of the block
// tile, MT = BM/64 m16 tiles, and all BN/8 n8 tiles: 2·MT·NT·4 accumulators a
// thread (80 for the 128 x 40 tile, the FP32 engine's count). Fragments are
// read from shared memory a word at a time in the m16n8k8 layouts (lane =
// 4·g + t): A (16 x 8, row) a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; B (8 x 8, col) b0 = B[t][g], b1 = B[t+4][g]; C (16 x 8)
// c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1].
// Bank conflicts: k-contiguous reads (stride 12 words) and column-contiguous
// B reads (stride BN = 40) fall on distinct banks; a column-contiguous A
// (stride BM, a multiple of 32) is read 4-way conflicted. A simple tile:
// wgmma, TMA and a conflict-free A layout are later work.

#pragma once

#include "cgemm_tile.cuh"

namespace tf32 {

using cgemm::Operand;
using cgemm::smem;

// -- PTX primitives -------------------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a · b on one m16n8k8 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// -- end PTX primitives ---------------------------------------------------------

constexpr uint32_t SIGN = 0x80000000u;

// BM x BN block tile of 128 threads; MINB blocks an SM (__launch_bounds__).
template <int BM_, int BN_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = 8, STAGES = STAGES_, MINB = MINB_;
  static constexpr int WARPS = 4, THREADS = 32 * WARPS;
  static constexpr int WM = BM / WARPS;  // rows of a warp
  static constexpr int MT = WM / 16;     // its m16 tiles
  static constexpr int NT = BN / 8;      // n8 tiles
  static constexpr int LDK = BK + 4;     // row stride of a staged k-contiguous tile
  static_assert(WM % 16 == 0 && BN % 8 == 0, "warps cover the tile in m16 x n8 tiles");

  // floats of one ring stage, as cgemm::Tile counts them (no resident A here)
  template <bool A_RESIDENT, bool A_KC, bool B_KC>
  __host__ __device__ static constexpr int stage_floats() {
    static_assert(!A_RESIDENT, "the TF32 tile stages A");
    return 2 * (BM * (A_KC ? LDK : BK) + (B_KC ? BN * LDK : BK * BN));
  }
};

// The tiles: 128 x 40 (column tiles of 40 divide N = 200) when the grid gives
// every SM two blocks, 64 x 40 otherwise and for 4-byte copies.
using Large = Tile<128, 40, 3, 2>;
using Small = Tile<64, 40, 3, 2>;

template <class T>
struct Acc {
  float r[T::MT][T::NT][4], i[T::MT][T::NT][4];
};

// (row, column) of accumulator e (c0..c3) of tile (mt, nt) in the block tile
template <class T>
__device__ __forceinline__ int acc_row(int mt, int e) {
  return threadIdx.x / 32 * T::WM + mt * 16 + threadIdx.x % 32 / 4 + (e >> 1) * 8;
}
template <class T>
__device__ __forceinline__ int acc_col(int nt, int e) {
  return nt * 8 + threadIdx.x % 4 * 2 + (e & 1);
}

// v as tf32 parts: hi, and with 3 passes lo = tf32(v − hi)
template <int PASSES>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = PASSES == 3 ? to_tf32(v - __uint_as_float(hi)) : 0u;
}

// d += a · b in PASSES passes
template <int PASSES>
__device__ __forceinline__ void mma_passes(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2], uint32_t sign) {
  if constexpr (PASSES == 3) {
    mma(d, al, bh[0] ^ sign, bh[1] ^ sign);
    mma(d, ah, bl[0] ^ sign, bl[1] ^ sign);
  }
  mma(d, ah, bh[0] ^ sign, bh[1] ^ sign);
}

// acc += A[the warp's rows, chunk] · B[chunk, 0 : BN] on one staged chunk.
// A staged k-contiguous (A_KC, row stride lda) or column-contiguous (column
// k at k·lda); B k-contiguous (B_KC, stride LDK) or column-contiguous
// (stride BN).
template <class T, bool A_KC, bool B_KC, bool CONJ_B, int PASSES>
__device__ __forceinline__ void mma_chunk(const float* __restrict__ ar,
                                          const float* __restrict__ ai, int lda,
                                          const float* __restrict__ br,
                                          const float* __restrict__ bi, Acc<T>& acc) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  uint32_t arh[T::MT][4], arl[T::MT][4], aih[T::MT][4], ail[T::MT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a0..a3: rows g, g + 8, g, g + 8; columns t, t, t + 4, t + 4
      const int r = threadIdx.x / 32 * T::WM + mt * 16 + g + (e & 1) * 8, k = t + (e >> 1) * 4;
      const int off = A_KC ? r * lda + k : k * lda + r;
      split<PASSES>(ar[off], arh[mt][e], arl[mt][e]);
      split<PASSES>(ai[off], aih[mt][e], ail[mt][e]);
    }
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    uint32_t brh[2], brl[2], bih[2], bil[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = t + 4 * e, n = nt * 8 + g;  // b0, b1
      const int off = B_KC ? n * T::LDK + k : k * T::BN + n;
      split<PASSES>(br[off], brh[e], brl[e]);
      split<PASSES>(bi[off], bih[e], bil[e]);
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      mma_passes<PASSES>(acc.r[mt][nt], arh[mt], arl[mt], brh, brl, 0u);
      mma_passes<PASSES>(acc.r[mt][nt], aih[mt], ail[mt], bih, bil, CONJ_B ? 0u : SIGN);
      mma_passes<PASSES>(acc.i[mt][nt], arh[mt], arl[mt], bih, bil, CONJ_B ? SIGN : 0u);
      mma_passes<PASSES>(acc.i[mt][nt], aih[mt], ail[mt], brh, brl, 0u);
    }
  }
}

// acc += A (BM x K) · B (K x BN) over the whole contraction, through the
// cp.async ring of cgemm::block_mma (same staging, same layouts). Ends with
// the ring drained and the block synchronised.
template <class T, bool A_KC, bool B_KC, int VEC, bool CONJ_B, int PASSES>
__device__ __forceinline__ void block_mma(float* ring, const Operand& a, const Operand& b, int K,
                                          int tid, Acc<T>& acc) {
  constexpr int AF = T::BM * (A_KC ? T::LDK : T::BK);
  constexpr int BF = B_KC ? T::BN * T::LDK : T::BK * T::BN;
  constexpr int SF = 2 * (AF + BF);
  const int nk = (K + T::BK - 1) / T::BK;
  auto load = [&](int chunk) {
    float* s = ring + (chunk % T::STAGES) * SF;
    const int k0 = chunk * T::BK;
    if constexpr (A_KC) {
      cgemm::stage_kc<T::BM, T::BK, T::THREADS, VEC>(s, a.re, a.ld, a.valid, k0, K, tid);
      cgemm::stage_kc<T::BM, T::BK, T::THREADS, VEC>(s + AF, a.im, a.ld, a.valid, k0, K, tid);
    } else {
      cgemm::stage_nc<T::BK, T::BM, T::THREADS, VEC>(s, a.re, a, k0, K, tid);
      cgemm::stage_nc<T::BK, T::BM, T::THREADS, VEC>(s + AF, a.im, a, k0, K, tid);
    }
    if constexpr (B_KC) {
      cgemm::stage_kc<T::BN, T::BK, T::THREADS, VEC>(s + 2 * AF, b.re, b.ld, b.valid, k0, K, tid);
      cgemm::stage_kc<T::BN, T::BK, T::THREADS, VEC>(s + 2 * AF + BF, b.im, b.ld, b.valid, k0, K,
                                                     tid);
    } else {
      cgemm::stage_nc<T::BK, T::BN, T::THREADS, VEC>(s + 2 * AF, b.re, b, k0, K, tid);
      cgemm::stage_nc<T::BK, T::BN, T::THREADS, VEC>(s + 2 * AF + BF, b.im, b, k0, K, tid);
    }
  };
#pragma unroll
  for (int c = 0; c < T::STAGES - 1; ++c) {
    if (c < nk) load(c);
    cgemm::cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cgemm::cp_async_wait<T::STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();                        // everyone's have, and chunk c − 1 is consumed
    if (c + T::STAGES - 1 < nk) load(c + T::STAGES - 1);
    cgemm::cp_async_commit();
    const float* s = ring + (c % T::STAGES) * SF;
    mma_chunk<T, A_KC, B_KC, CONJ_B, PASSES>(s, s + AF, A_KC ? T::LDK : T::BM, s + 2 * AF,
                                             s + 2 * AF + BF, acc);
  }
  cgemm::cp_async_wait<0>();
  __syncthreads();
}

template <class T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.r[mt][nt][e] = acc.i[mt][nt][e] = 0.f;
}

// cgemm::slab_tile on the tensor cores: one block's tile of
//   y[o, j, i] = Σ_k B[j, k] · x[o, k, i]      x, y: (O, N, I)
// for the slab columns [m0, m0 + rows) and j in [n0, n0 + BN), B = W
// k-contiguous (B_KC) or, with CONJ_B, Wᴴ read in place; the output tile goes
// through shared memory so that neighbouring threads store neighbouring i.
template <class T, int VEC, bool B_KC, bool CONJ_B, int PASSES>
__device__ __forceinline__ void slab_tile(const float* __restrict__ xr,
                                          const float* __restrict__ xi,
                                          const float* __restrict__ wr,
                                          const float* __restrict__ wi, float* __restrict__ yr,
                                          float* __restrict__ yi, long m0, int rows, int n0,
                                          int N, int I) {
  static_assert(B_KC != CONJ_B, "instances: W k-contiguous, or Wᴴ read in place");
  const Operand a{xr, xi, I, rows, m0, I, static_cast<long>(N) * I};
  const Operand b = B_KC ? Operand{wr + static_cast<long>(n0) * N, wi + static_cast<long>(n0) * N,
                                   N, N - n0}
                         : Operand{wr + n0, wi + n0, N, N - n0};
  Acc<T> acc;
  zero<T>(acc);
  block_mma<T, false, B_KC, VEC, CONJ_B, PASSES>(reinterpret_cast<float*>(smem), a, b, N,
                                                 threadIdx.x, acc);
  constexpr int LDT = T::BM + 4;  // the lanes' writes, 8t + g, on distinct banks
  static_assert(T::BN * LDT + 2 * T::BM <=
                    T::STAGES * T::template stage_floats<false, false, B_KC>(),
                "the output tile and its column offsets fit the ring");
  float* const tile = reinterpret_cast<float*>(smem);
  long* const offset = reinterpret_cast<long*>(tile + T::BN * LDT);
  for (int r = threadIdx.x; r < rows; r += T::THREADS) offset[r] = cgemm::column_offset(a, r);
  for (int part = 0; part < 2; ++part) {
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile[acc_col<T>(nt, e) * LDT + acc_row<T>(mt, e)] =
              part ? acc.i[mt][nt][e] : acc.r[mt][nt][e];
    __syncthreads();
    float* const y = part ? yi : yr;
    for (int e = threadIdx.x; e < T::BN * T::BM; e += T::THREADS) {
      const int j = e / T::BM, r = e % T::BM;
      if (r < rows && n0 + j < N) y[offset[r] + static_cast<long>(n0 + j) * I] = tile[j * LDT + r];
    }
    __syncthreads();
  }
}

// The I == 1 instance: y = x · Wᵀ on the rows [m0, m0 + rows) of x (O x N)
// and the columns [n0, n0 + BN) of y, both operands k-contiguous.
template <class T, int VEC, int PASSES>
__device__ __forceinline__ void rows_tile(const float* __restrict__ xr,
                                          const float* __restrict__ xi,
                                          const float* __restrict__ wr,
                                          const float* __restrict__ wi, float* __restrict__ yr,
                                          float* __restrict__ yi, long m0, int rows, int n0,
                                          int N) {
  const Operand a{xr + m0 * N, xi + m0 * N, N, rows};
  const Operand b{wr + static_cast<long>(n0) * N, wi + static_cast<long>(n0) * N, N, N - n0};
  Acc<T> acc;
  zero<T>(acc);
  block_mma<T, true, true, VEC, false, PASSES>(reinterpret_cast<float*>(smem), a, b, N,
                                               threadIdx.x, acc);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row<T>(mt, e), j = n0 + acc_col<T>(nt, e);
        if (r < rows && j < N) {
          yr[(m0 + r) * N + j] = acc.r[mt][nt][e];
          yi[(m0 + r) * N + j] = acc.i[mt][nt][e];
        }
      }
}

}  // namespace tf32
