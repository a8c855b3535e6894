// Passes shared by the masked normal apply (csrc/normal_apply.cu) and its
// backward (csrc/normal_apply_bwd.cu), on planar (re, im) float32 operands
// with frames f = b·T + t, coils c and P = H·W pixels a plane:
//
// - products: y[f, c] = S[b, c] ⊙ u[f], written as (B·T·C, H, W) slabs
//   (u = x, or the cotangent g); one memory pass. With UNFUSED (the TF32
//   modes) each product and the sum are rounded on their own, with no FMA
//   contraction, as PyTorch computes ``sr * ur - si * ui``: those modes round
//   y to TF32 in the contraction, so a one-ulp difference in y would move a
//   TF32 operand by 2⁻¹⁰ and the plain version could not reproduce the
//   kernel. 'highest' keeps the compiler's FMA contraction.
// - contraction: z[f, c] = K_f ·_h y[f, c], or K_fᴴ ·_h y[f, c]. For one
//   frame the contraction over all coils is one complex product,
//   K_f (H x H) · [y[f, 1] | … | y[f, C]] (H x C·W): the tile engine's
//   slab_tile (cgemm_tile.cuh), the DFT kernel's slab instance with a K per
//   block. Slabs that share one K form a group: a frame's C slabs when K is
//   per frame (kt = T), a batch row's T·C slabs when it is not (kt = 1,
//   then the product is the DFT instance as it stands). A row tile never
//   straddles two groups: tiles are clipped at group boundaries (the last
//   tile of a group is partial: 80 of 128 slab columns at C·W = 2000), so
//   a block reads one K. Kᴴ is read in place as a column-contiguous,
//   conjugated B: no transposed copy of K. With PASSES = 1 or 3 (the
//   'default' and 'high' modes) the contraction runs on the TF32 tensor-core
//   tile of cgemm_tf32.cuh, else on the FP32 engine of cgemm_tile.cuh.
//
// Each __global__ kernel is defined in the .cu that launches it, under a
// name that the profiler fold (instrument/opstats.py) maps to its kind.

#pragma once

#include "cgemm_tf32.cuh"

namespace normal {

constexpr int PASS_THREADS = 256;

// VEC consecutive floats of one array, moved as one float4 when VEC == 4.
template <int VEC>
struct Pack {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Pack<VEC> load(const float* p) {
  Pack<VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x, r.v[1] = q.y, r.v[2] = q.z, r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Pack<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// One thread's VEC pixels of y[f, c] = S[b, c] ⊙ u[f]: thread e of the
// B·T·C·P / VEC.
template <int VEC, bool UNFUSED>
__device__ __forceinline__ void products(const float* __restrict__ ur, const float* __restrict__ ui,
                                         const float* __restrict__ sr, const float* __restrict__ si,
                                         float* __restrict__ yr, float* __restrict__ yi, int T,
                                         int C, long P, long n) {
  const long e = static_cast<long>(blockIdx.x) * PASS_THREADS + threadIdx.x;
  if (e >= n) return;
  const long pv = P / VEC;
  const long slab = e / pv, p = e % pv * VEC;
  const long f = slab / C, b = f / T;
  const long so = (b * C + slab % C) * P + p, uo = f * P + p, yo = slab * P + p;
  const Pack<VEC> s_r = load<VEC>(sr + so), s_i = load<VEC>(si + so);
  const Pack<VEC> u_r = load<VEC>(ur + uo), u_i = load<VEC>(ui + uo);
  Pack<VEC> y_r, y_i;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    if constexpr (UNFUSED) {
      y_r.v[v] = __fsub_rn(__fmul_rn(s_r.v[v], u_r.v[v]), __fmul_rn(s_i.v[v], u_i.v[v]));
      y_i.v[v] = __fadd_rn(__fmul_rn(s_r.v[v], u_i.v[v]), __fmul_rn(s_i.v[v], u_r.v[v]));
    } else {
      y_r.v[v] = s_r.v[v] * u_r.v[v] - s_i.v[v] * u_i.v[v];
      y_i.v[v] = s_r.v[v] * u_i.v[v] + s_i.v[v] * u_r.v[v];
    }
  }
  store<VEC>(yr + yo, y_r);
  store<VEC>(yi + yo, y_i);
}

// One block's tile of the contraction over the (B·T·C, H, W) slabs: blocks
// run over (row tile of a group, column tile) along x, the column tiles of a
// row tile side by side as in the DFT kernel, and over the groups along y;
// G slabs a group, whose K is K + group·H·H. PASSES 0: the FP32 engine
// (T a cgemm::Tile); 1 or 3: the TF32 tile (T a tf32::Tile).
template <class T, int VEC, bool ADJOINT, int PASSES = 0>
__device__ __forceinline__ void contract(const float* __restrict__ yr, const float* __restrict__ yi,
                                         const float* __restrict__ kr, const float* __restrict__ ki,
                                         float* __restrict__ zr, float* __restrict__ zi, int H,
                                         int W, int G, int n_tiles) {
  const long cols = static_cast<long>(G) * W;  // slab columns of a group
  const long m0 = static_cast<long>(blockIdx.x / n_tiles) * T::BM;
  const int n0 = blockIdx.x % n_tiles * T::BN;
  const int rows = cols - m0 < T::BM ? static_cast<int>(cols - m0) : T::BM;
  const long k = static_cast<long>(blockIdx.y) * H * H;
  if constexpr (PASSES == 0) {
    cgemm::slab_tile<T, VEC, !ADJOINT, ADJOINT>(yr, yi, kr + k, ki + k, zr, zi,
                                                blockIdx.y * cols + m0, rows, n0, H, W);
  } else {
    tf32::slab_tile<T, VEC, !ADJOINT, ADJOINT, PASSES>(yr, yi, kr + k, ki + k, zr, zi,
                                                       blockIdx.y * cols + m0, rows, n0, H, W);
  }
}

// One thread's VEC pixels of out[f] = Σ_c conj(S[b, c]) ⊙ z[f, c] + λ·u[f]:
// thread e of the B·T·P / VEC.
template <int VEC>
__device__ __forceinline__ void coil_reduce(const float* __restrict__ zr,
                                            const float* __restrict__ zi,
                                            const float* __restrict__ sr,
                                            const float* __restrict__ si,
                                            const float* __restrict__ ur,
                                            const float* __restrict__ ui,
                                            const float* __restrict__ lamp, float* __restrict__ outr,
                                            float* __restrict__ outi, int T, int C, long P, long n) {
  const long e = static_cast<long>(blockIdx.x) * PASS_THREADS + threadIdx.x;
  if (e >= n) return;
  const long pv = P / VEC;
  const long f = e / pv, p = e % pv * VEC, b = f / T;
  Pack<VEC> ar, ai;
#pragma unroll
  for (int v = 0; v < VEC; ++v) ar.v[v] = ai.v[v] = 0.f;
  for (int c = 0; c < C; ++c) {
    const long zo = (f * C + c) * P + p, so = (b * C + c) * P + p;
    const Pack<VEC> z_r = load<VEC>(zr + zo), z_i = load<VEC>(zi + zo);
    const Pack<VEC> s_r = load<VEC>(sr + so), s_i = load<VEC>(si + so);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      ar.v[v] += s_r.v[v] * z_r.v[v] + s_i.v[v] * z_i.v[v];
      ai.v[v] += s_r.v[v] * z_i.v[v] - s_i.v[v] * z_r.v[v];
    }
  }
  const float lam = *lamp;
  const Pack<VEC> u_r = load<VEC>(ur + f * P + p), u_i = load<VEC>(ui + f * P + p);
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    ar.v[v] += lam * u_r.v[v];
    ai.v[v] += lam * u_i.v[v];
  }
  store<VEC>(outr + f * P + p, ar);
  store<VEC>(outi + f * P + p, ai);
}

// Launch a pass over `threads` threads (none: nothing to launch).
template <auto Kernel, class... Args>
int launch_pass(long threads, cudaStream_t s, Args... args) {
  if (threads == 0) return 0;
  const dim3 grid(static_cast<unsigned>((threads + PASS_THREADS - 1) / PASS_THREADS));
  return cgemm::launch<Kernel>(grid, PASS_THREADS, 0, s, args...);
}

// Launch a contraction kernel of tile T over `groups` groups of G slabs.
template <class T, bool ADJOINT, auto Kernel>
int launch_contract(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
                    float* zi, int groups, int G, int H, int W, cudaStream_t s) {
  constexpr int smem = T::STAGES * T::template stage_floats<false, false, !ADJOINT>() * sizeof(float);
  const long cols = static_cast<long>(G) * W;
  const int n_tiles = (H + T::BN - 1) / T::BN;
  const dim3 grid(static_cast<unsigned>((cols + T::BM - 1) / T::BM * n_tiles), groups);
  if (grid.x == 0 || grid.y == 0) return 0;
  return cgemm::launch<Kernel>(grid, T::THREADS, smem, s, yr, yi, kr, ki, zr, zi, H, W, G, n_tiles);
}

// The tile of the adjoint contraction (Kᴴ read in place, a conjugated
// column-contiguous B). Under the large tile's cap of 128 registers (4
// blocks an SM) it holds one A value at a time and waits on each shared
// load; with 3 blocks an SM (161 registers) and two k steps unrolled it
// loads ahead, as the k-contiguous instance does at 128.
using Adjoint = cgemm::Tile<128, 40, 8, 8, 5, 3, 3, 2>;

// 16-byte copies in the contraction when K's rows and the slabs' rows are
// 16-byte aligned (the large tile), else 4-byte ones (the small tile), as
// the DFT kernel chooses.
inline bool tile_vec(int H, int W, const void* kr, const void* ki, const void* yr, const void* yi,
                     const void* zr, const void* zi) {
  return H % 4 == 0 && W % 4 == 0 && cgemm::aligned16(kr) && cgemm::aligned16(ki) &&
         cgemm::aligned16(yr) && cgemm::aligned16(yi) && cgemm::aligned16(zr) &&
         cgemm::aligned16(zi);
}

}  // namespace normal
