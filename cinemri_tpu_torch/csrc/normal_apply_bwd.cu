// Backward of the masked normal operator apply, planar (re, im) float32.
//
// Forward (csrc/normal_apply.cu):
//   out[b,t] = Σ_c conj(S[b,c]) ⊙ (K[b,t'] ·_h (S[b,c] ⊙ x[b,t])) + λ·x[b,t]
// For the cotangent g of out, with ȳ_c = Kᴴ ·_h (S_c ⊙ g) and
// z_c = K ·_h (S_c ⊙ x) (recomputed, not saved):
//   x̄[b,t]   = Σ_c conj(S_c) ⊙ ȳ_c + λ·g
//   s̄[b,c]   = Σ_t conj(g) ⊙ z_c + ȳ_c ⊙ conj(x)
//   λ̄[b,t]   = Σ_{h,w} Re(g ⊙ conj(x))   (partials; the caller sums them)
//
//   x, g, x̄: (b, t, h, w)   K: (b, kt, h, h), t' = t if kt > 1 else 0
//   S, s̄: (b, c, h, w)      λ̄: (b, t)
//   λ: one float32 in device memory, read by the kernel
//
// Replaces the backward Pallas kernel _bwd_pallas_call (cinemri_tpu/ops/
// kernels/normal_pallas.py:203, body _bwd_kernel) of normal_apply_pallas,
// the custom VJP that carries the normal apply through the train steps.
//
// Arithmetic of the two contractions, by the launch's mode, as in the
// forward (csrc/normal_apply.cu): 0, 'highest', full f32 FMA on CUDA cores;
// 1, 'high', 3xTF32 and 2, 'default', 1xTF32 on the tensor cores
// (cgemm_tf32.cuh). The products and the passes after the contractions stay
// f32 in every mode.
//
// What bounds it on the H100: two h-contractions per coil, 16·t·c·h·h·w
// FLOP (19.2 GFLOP at t=15, c=10, h=w=200) against about 30 MB of inputs
// and outputs: the FP32 rate (0.29 ms at 67 TFLOP/s).
//
// Design: the two contractions are the forward's coil-stacked per-frame
// products on the tile engine (normal_passes.cuh), ȳ with Kᴴ read in place
// (a conjugated, column-contiguous B: no transposed copy of K). One C entry
// launches seven kernels on three (b·t·c, h, w) scratch pairs (144 MB at
// the flagship):
// 1. v = S_c ⊙ g into the products scratch;
// 2. ȳ = Kᴴ ·_h v (the tile normal::Adjoint, 3 blocks an SM);
// 3. y = S_c ⊙ x into the products scratch (v is consumed);
// 4. z = K ·_h y;
// 5. x̄_t = Σ_c conj(S_c) ⊙ ȳ_c + λg, the forward's coil reduction;
// 6. s̄_c = Σ_t conj(g_t) ⊙ z_{t,c} + ȳ_{t,c} ⊙ conj(x_t): a thread owns
//    four pixels of one coil and sums over the frames in registers. The
//    Pallas kernel sums s̄ into an output block that stays resident across
//    the TPU's sequential grid; here no per-frame partials and no atomics
//    are needed, and the sum is deterministic;
// 7. λ̄'s partials, one block per (b, t).
// Passes 5 and 6 read ȳ twice (one more 48 MB pass) and keep b·c·h·w / 4
// threads busy. One pass per pixel over t and c, holding s̄ for every coil
// in registers, would read ȳ once, but has b·h·w threads of ~200
// registers: too few warps to cover the memory latency, and it measured
// slower than the two passes together on the H100.

#include <type_traits>

#include "normal_passes.cuh"

namespace {

using normal::Pack;

template <int VEC, bool UNFUSED>
__global__ void __launch_bounds__(normal::PASS_THREADS)
normal_apply_bwd_products_kernel(const float* __restrict__ ur, const float* __restrict__ ui,
                                 const float* __restrict__ sr, const float* __restrict__ si,
                                 float* __restrict__ yr, float* __restrict__ yi, int T, int C,
                                 long P, long n) {
  normal::products<VEC, UNFUSED>(ur, ui, sr, si, yr, yi, T, C, P, n);
}

template <class T, int VEC, bool ADJOINT, int PASSES>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
normal_apply_bwd_contract_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                                 const float* __restrict__ kr, const float* __restrict__ ki,
                                 float* __restrict__ zr, float* __restrict__ zi, int H, int W,
                                 int G, int n_tiles) {
  normal::contract<T, VEC, ADJOINT, PASSES>(yr, yi, kr, ki, zr, zi, H, W, G, n_tiles);
}

// Step 5: x̄[f] = Σ_c conj(S_c) ⊙ ȳ[f, c] + λ·g[f], the forward's coil
// reduction on ȳ and g.
template <int VEC>
__global__ void __launch_bounds__(normal::PASS_THREADS)
normal_apply_bwd_xbar_kernel(const float* __restrict__ ybr, const float* __restrict__ ybi,
                             const float* __restrict__ sr, const float* __restrict__ si,
                             const float* __restrict__ gr, const float* __restrict__ gi,
                             const float* __restrict__ lamp, float* __restrict__ xbr,
                             float* __restrict__ xbi, int T, int C, long P, long n) {
  normal::coil_reduce<VEC>(ybr, ybi, sr, si, gr, gi, lamp, xbr, xbi, T, C, P, n);
}

// Step 6: s̄[b, c] = Σ_t conj(g[f]) ⊙ z[f, c] + ȳ[f, c] ⊙ conj(x[f]): thread e
// of the B·C·P / VEC owns VEC pixels of coil c and sums over the frames in
// registers.
template <int VEC>
__global__ void __launch_bounds__(normal::PASS_THREADS)
normal_apply_bwd_sbar_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                             const float* __restrict__ gr, const float* __restrict__ gi,
                             const float* __restrict__ ybr, const float* __restrict__ ybi,
                             const float* __restrict__ zr, const float* __restrict__ zi,
                             float* __restrict__ sbr, float* __restrict__ sbi, int T, int C,
                             long P, long n) {
  const long e = static_cast<long>(blockIdx.x) * normal::PASS_THREADS + threadIdx.x;
  if (e >= n) return;
  const long pv = P / VEC;
  const long bc = e / pv, p = e % pv * VEC, b = bc / C, c = bc % C;
  Pack<VEC> ar, ai;
#pragma unroll
  for (int v = 0; v < VEC; ++v) ar.v[v] = ai.v[v] = 0.f;
  for (int t = 0; t < T; ++t) {
    const long f = b * T + t, o = (f * C + c) * P + p, q = f * P + p;
    const Pack<VEC> y_r = normal::load<VEC>(ybr + o), y_i = normal::load<VEC>(ybi + o);
    const Pack<VEC> z_r = normal::load<VEC>(zr + o), z_i = normal::load<VEC>(zi + o);
    const Pack<VEC> x_r = normal::load<VEC>(xr + q), x_i = normal::load<VEC>(xi + q);
    const Pack<VEC> g_r = normal::load<VEC>(gr + q), g_i = normal::load<VEC>(gi + q);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      ar.v[v] += g_r.v[v] * z_r.v[v] + g_i.v[v] * z_i.v[v] + y_r.v[v] * x_r.v[v] +
                 y_i.v[v] * x_i.v[v];
      ai.v[v] += g_r.v[v] * z_i.v[v] - g_i.v[v] * z_r.v[v] + y_i.v[v] * x_r.v[v] -
                 y_r.v[v] * x_i.v[v];
    }
  }
  normal::store<VEC>(sbr + bc * P + p, ar);
  normal::store<VEC>(sbi + bc * P + p, ai);
}

// Step 7: λ̄[b, t] = Σ_{h,w} g_re·x_re + g_im·x_im, one block per (b, t).
constexpr int LB_THREADS = 1024;

template <int VEC>
__global__ void __launch_bounds__(LB_THREADS)
normal_apply_bwd_lambda_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                               const float* __restrict__ gr, const float* __restrict__ gi,
                               float* __restrict__ lb, long P) {
  __shared__ float warp_sums[LB_THREADS / 32];
  const long off = static_cast<long>(blockIdx.x) * P;
  float s = 0.f;
  for (long p = threadIdx.x * VEC; p < P; p += LB_THREADS * VEC) {
    const Pack<VEC> x_r = normal::load<VEC>(xr + off + p), x_i = normal::load<VEC>(xi + off + p);
    const Pack<VEC> g_r = normal::load<VEC>(gr + off + p), g_i = normal::load<VEC>(gi + off + p);
#pragma unroll
    for (int v = 0; v < VEC; ++v) s += g_r.v[v] * x_r.v[v] + g_i.v[v] * x_i.v[v];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int j = 0; j < LB_THREADS / 32; ++j) total += warp_sums[j];
    lb[blockIdx.x] = total;
  }
}

// y = S ⊙ u, with no FMA contraction in the TF32 modes (normal_passes.cuh)
template <int VEC>
int products(const float* ur, const float* ui, const float* sr, const float* si, float* yr,
             float* yi, int b, int t, int c, long P, int mode, cudaStream_t s) {
  const long n = static_cast<long>(b) * t * c * (P / VEC);
  return mode == 0 ? normal::launch_pass<normal_apply_bwd_products_kernel<VEC, false>>(
                         n, s, ur, ui, sr, si, yr, yi, t, c, P, n)
                   : normal::launch_pass<normal_apply_bwd_products_kernel<VEC, true>>(
                         n, s, ur, ui, sr, si, yr, yi, t, c, P, n);
}

template <class T, int VEC, bool ADJOINT, int PASSES>
int contract(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
             float* zi, int groups, int G, int h, int w, cudaStream_t s) {
  return normal::launch_contract<T, ADJOINT,
                                 normal_apply_bwd_contract_kernel<T, VEC, ADJOINT, PASSES>>(
      yr, yi, kr, ki, zr, zi, groups, G, h, w, s);
}

// The contraction with K (ADJOINT: Kᴴ) in the mode's engine: the FP32 tiles
// (PASSES 0; the adjoint's own wide tile) or the TF32 tiles (1, 3).
template <bool ADJOINT, int PASSES>
int contract_in(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
                float* zi, int groups, int G, int h, int w, bool wide, cudaStream_t s) {
  using FL = std::conditional_t<ADJOINT, normal::Adjoint, cgemm::Large>;
  using TL = std::conditional_t<PASSES == 0, FL, tf32::Large>;
  using TS = std::conditional_t<PASSES == 0, cgemm::Small, tf32::Small>;
  return wide ? contract<TL, 4, ADJOINT, PASSES>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s)
              : contract<TS, 1, ADJOINT, PASSES>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s);
}

template <bool ADJOINT>
int contraction(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
                float* zi, int groups, int G, int h, int w, bool wide, int mode, cudaStream_t s) {
  return mode == 0   ? contract_in<ADJOINT, 0>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s)
         : mode == 1 ? contract_in<ADJOINT, 3>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s)
                     : contract_in<ADJOINT, 1>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s);
}

template <int VEC>
int passes(const float* xr, const float* xi, const float* gr, const float* gi, const float* sr,
           const float* si, const float* lam, float* xbr, float* xbi, float* sbr, float* sbi,
           float* lb, const float* ybr, const float* ybi, const float* zr, const float* zi, int b,
           int t, int c, long P, cudaStream_t s) {
  const long pv = P / VEC;
  int err = normal::launch_pass<normal_apply_bwd_xbar_kernel<VEC>>(
      b * t * pv, s, ybr, ybi, sr, si, gr, gi, lam, xbr, xbi, t, c, P, b * t * pv);
  if (err) return err;
  err = normal::launch_pass<normal_apply_bwd_sbar_kernel<VEC>>(
      b * c * pv, s, xr, xi, gr, gi, ybr, ybi, zr, zi, sbr, sbi, t, c, P, b * c * pv);
  if (err) return err;
  return cgemm::launch<normal_apply_bwd_lambda_kernel<VEC>>(dim3(b * t), LB_THREADS, 0, s, xr, xi,
                                                             gr, gi, lb, P);
}

}  // namespace

// pr, pi, ybr, ybi, zr, zi: scratch of b·t·c·h·w floats each, allocated by
// the caller. mode: 0 'highest', 1 'high', 2 'default'.
extern "C" int cinemri_normal_apply_bwd(const float* xr, const float* xi, const float* gr,
                                        const float* gi, const float* kr, const float* ki,
                                        const float* sr, const float* si, const float* lam,
                                        float* xbr, float* xbi, float* sbr, float* sbi, float* lb,
                                        float* pr, float* pi, float* ybr, float* ybi, float* zr,
                                        float* zi, int b, int t, int c, int h, int w, int kt,
                                        int mode, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = static_cast<long>(h) * w;
  const bool vec = P % 4 == 0 && cgemm::aligned16(xr) && cgemm::aligned16(xi) &&
                   cgemm::aligned16(gr) && cgemm::aligned16(gi) && cgemm::aligned16(sr) &&
                   cgemm::aligned16(si) && cgemm::aligned16(pr) && cgemm::aligned16(pi) &&
                   cgemm::aligned16(ybr) && cgemm::aligned16(ybi) && cgemm::aligned16(zr) &&
                   cgemm::aligned16(zi) && cgemm::aligned16(xbr) && cgemm::aligned16(xbi) &&
                   cgemm::aligned16(sbr) && cgemm::aligned16(sbi);
  const bool wide = normal::tile_vec(h, w, kr, ki, pr, pi, ybr, ybi) &&
                    cgemm::aligned16(zr) && cgemm::aligned16(zi);
  const int groups = b * kt, G = t * c / kt;  // slabs sharing one K
  // 1-2: ȳ = Kᴴ ·_h (S ⊙ g)
  int err = vec ? products<4>(gr, gi, sr, si, pr, pi, b, t, c, P, mode, s)
                : products<1>(gr, gi, sr, si, pr, pi, b, t, c, P, mode, s);
  if (err) return err;
  err = contraction<true>(pr, pi, kr, ki, ybr, ybi, groups, G, h, w, wide, mode, s);
  if (err) return err;
  // 3-4: z = K ·_h (S ⊙ x)
  err = vec ? products<4>(xr, xi, sr, si, pr, pi, b, t, c, P, mode, s)
            : products<1>(xr, xi, sr, si, pr, pi, b, t, c, P, mode, s);
  if (err) return err;
  err = contraction<false>(pr, pi, kr, ki, zr, zi, groups, G, h, w, wide, mode, s);
  if (err) return err;
  // 5-7: x̄, s̄ and λ̄'s partials
  return vec ? passes<4>(xr, xi, gr, gi, sr, si, lam, xbr, xbi, sbr, sbi, lb, ybr, ybi, zr, zi, b,
                         t, c, P, s)
             : passes<1>(xr, xi, gr, gi, sr, si, lam, xbr, xbi, sbr, sbi, lb, ybr, ybi, zr, zi, b,
                         t, c, P, s);
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
