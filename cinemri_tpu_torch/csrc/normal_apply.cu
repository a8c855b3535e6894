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
// (cinemri_tpu/ops/kernels/normal_pallas.py:182, body _fwd_kernel). It
// carries N(z) in every VarNet cascade's data-consistency step (λ = 0) and
// every CineNet conjugate-gradient apply (λ = softplus of a learned weight)
// through physics/operators.py::normal_plus_lambda_kernel.
//
// Arithmetic of the contraction, by the launch's mode (the JAX package's
// normal_pallas.py reads the DFT precision, _precision(), the same way):
// 0, 'highest': the 4-multiplication complex product in full f32 on CUDA
// cores (FMA, no TF32), Precision.HIGHEST; 1, 'high': 3xTF32 and 2,
// 'default': 1xTF32 on the tensor cores. The products and the coil
// reduction stay f32 in every mode; the TF32 modes form the products without
// FMA contraction, as the plain version does.
//
// What bounds it on the H100: per apply it does 8·t·c·h·h·w FLOP (9.6 GFLOP
// at t=15, c=10, h=w=200) against about 18 MB of inputs and outputs, so it
// is bound by the FP32 rate (0.14 ms at 67 TFLOP/s). The Pallas program
// keeps a whole (h, w) plane, K and the coil stack on chip (about 8 MB); a
// block has 227 KB of shared memory.
//
// Design: for one frame the contraction over all coils is one complex
// product, K_t (h x h) · [S_1⊙x_t | … | S_C⊙x_t] (h x c·w); at the flagship
// 15 of them, the shape and FLOP of the DFT kernel's (150, 200, 200) slab
// instance. So one C entry launches three kernels (normal_passes.cuh):
// (a) the products y = S_c ⊙ x_t into a (b·t·c, h, w) scratch (48 MB at
//     the flagship), one memory pass;
// (b) z = K_t ·_h y on the tile engine (cgemm_tile.cuh: cp.async ring, 8 x 5
//     complex outputs a thread, column tiles of 40 that divide 200), row
//     tiles clipped at frame boundaries so that each block reads one K;
// (c) out = Σ_c conj(S_c) ⊙ z_c + λx, one memory pass reading z once.
// The scratch costs three passes over 48 MB (~0.05 ms at 3.35 TB/s) and
// buys the engine's tile. A kernel that forms S_c⊙x in shared memory per
// (w-tile, h-tile, frame) block instead has to restage K per coil, and its
// 64 x 64 output tiles over a 200 x 200 plane spend 39% of the FMAs on
// padding.
//
// The TF32 modes run (b) on the Hopper tile of wgmma_tf32.cuh. At 'default'
// it fuses (a) into (b): the resident tile stages x_t and S_c (raw, by
// cp.async) and forms y = S_c ⊙ x_t while rounding its A, one operation at a
// time as (a) does, once per element, so a call launches two kernels, the
// contraction with its products and (c), and y never reaches device memory
// (the caller's y scratch goes unused). At 'high' the products' hi and lo
// would not fit a resident A, and streaming x and S per 40-column tile
// doubles the L2 traffic of streaming y (on an H100: 0.55 ms against the
// three kernels' 0.30 at the flagship), so (a) stays and (b) runs on the
// streaming tile. Rows that are not 16-byte aligned keep (a), (b) on the
// mma.sync tile of cgemm_tf32.cuh and (c). The TF32 routes are shared with
// the backward's two contractions (normal_wgmma.cuh).

#include <type_traits>

#include "normal_wgmma.cuh"

namespace {

template <int VEC, bool UNFUSED>
__global__ void __launch_bounds__(normal::PASS_THREADS)
normal_apply_products_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                             const float* __restrict__ sr, const float* __restrict__ si,
                             float* __restrict__ yr, float* __restrict__ yi, int T, int C, long P,
                             long n) {
  normal::products<VEC, UNFUSED>(xr, xi, sr, si, yr, yi, T, C, P, n);
}

template <class T, int VEC, int PASSES>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
normal_apply_contract_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                             const float* __restrict__ kr, const float* __restrict__ ki,
                             float* __restrict__ zr, float* __restrict__ zi, int H, int W, int G,
                             int n_tiles) {
  normal::contract<T, VEC, false, PASSES>(yr, yi, kr, ki, zr, zi, H, W, G, n_tiles);
}

// The TF32 modes' contraction on the Hopper tile: z[f, c] = K_g ·_h y[f, c]
// over the groups of slabs sharing one K, y the products' scratch ('high').
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1) normal_apply_wgmma_kernel(const wgmma::Problem p) {
  wgmma::run<T>(p);
}

// 'default': the same with the products fused into its staging,
// z[f, c] = K_g ·_h (S_c ⊙ x_f), A resident in shared memory (h ≤ 224).
template <class R>
__global__ void __launch_bounds__(R::THREADS, 1)
normal_apply_wgmma_resident_kernel(const wgmma::Problem p) {
  wgmma::run_resident<R>(p);
}

template <int VEC>
__global__ void __launch_bounds__(normal::PASS_THREADS)
normal_apply_reduce_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                           const float* __restrict__ sr, const float* __restrict__ si,
                           const float* __restrict__ xr, const float* __restrict__ xi,
                           const float* __restrict__ lamp, float* __restrict__ outr,
                           float* __restrict__ outi, int T, int C, long P, long n) {
  normal::coil_reduce<VEC>(zr, zi, sr, si, xr, xi, lamp, outr, outi, T, C, P, n);
}

// y = S ⊙ x, with no FMA contraction in the TF32 modes (normal_passes.cuh)
template <int VEC>
int products(const float* xr, const float* xi, const float* sr, const float* si, float* yr,
             float* yi, int b, int t, int c, long P, int mode, cudaStream_t s) {
  const long n = static_cast<long>(b) * t * c * (P / VEC);
  return mode == 0 ? normal::launch_pass<normal_apply_products_kernel<VEC, false>>(
                         n, s, xr, xi, sr, si, yr, yi, t, c, P, n)
                   : normal::launch_pass<normal_apply_products_kernel<VEC, true>>(
                         n, s, xr, xi, sr, si, yr, yi, t, c, P, n);
}

// z = K ·_h y on the FP32 engine (PASSES 0) or the TF32 tile (1, 3)
template <int PASSES>
int contraction(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
                float* zi, int groups, int G, int h, int w, cudaStream_t s) {
  using TL = std::conditional_t<PASSES == 0, cgemm::Large, tf32::Large>;
  using TS = std::conditional_t<PASSES == 0, cgemm::Small, tf32::Small>;
  return normal::tile_vec(h, w, kr, ki, yr, yi, zr, zi)
             ? normal::launch_contract<TL, false, normal_apply_contract_kernel<TL, 4, PASSES>>(
                   yr, yi, kr, ki, zr, zi, groups, G, h, w, s)
             : normal::launch_contract<TS, false, normal_apply_contract_kernel<TS, 1, PASSES>>(
                   yr, yi, kr, ki, zr, zi, groups, G, h, w, s);
}

// This file's kernels on the routes of normal_wgmma.cuh.
struct Kernels {
  template <class T>
  static int streaming(const wgmma::Problem& p, cudaStream_t s) {
    return wgmma::launch<T, normal_apply_wgmma_kernel<T>>(p, s);
  }
  template <class R>
  static int resident(const wgmma::Problem& p, cudaStream_t s) {
    return wgmma::launch_resident<R, normal_apply_wgmma_resident_kernel<R>>(p, s);
  }
  template <int VEC, bool UNFUSED, class... Args>
  static int products(long n, cudaStream_t s, Args... args) {
    return normal::launch_pass<normal_apply_products_kernel<VEC, UNFUSED>>(n, s, args...);
  }
};

template <int VEC>
int reduce(const float* zr, const float* zi, const float* sr, const float* si, const float* xr,
           const float* xi, const float* lam, float* outr, float* outi, int b, int t, int c,
           long P, cudaStream_t s) {
  const long n = static_cast<long>(b) * t * (P / VEC);
  return normal::launch_pass<normal_apply_reduce_kernel<VEC>>(n, s, zr, zi, sr, si, xr, xi, lam,
                                                              outr, outi, t, c, P, n);
}

}  // namespace

// The route of a call (normal_wgmma.cuh: 0 the tile engines, 1 the products
// pass and the streaming Hopper tile, 2 the resident Hopper tile with the
// products fused), for the caller's operands and an output and scratch that
// the caller allocates (16-byte aligned): which scratch the call needs.
extern "C" int cinemri_normal_apply_route(const float* xr, const float* xi, const float* kr,
                                          const float* ki, const float* sr, const float* si, int b,
                                          int t, int c, int h, int w, int kt, int mode) {
  return normal::route(mode, normal::all_aligned16(xr, xi, kr, ki, sr, si), b, t, c, h, w, kt);
}

// yr, yi, zr, zi: scratch of b·t·c·h·w floats each, allocated by the caller
// (yr and yi unused, and may be null, on route 2).
// mode: 0 'highest', 1 'high', 2 'default'.
extern "C" int cinemri_normal_apply(const float* xr, const float* xi, const float* kr,
                                    const float* ki, const float* sr, const float* si,
                                    const float* lam, float* outr, float* outi, float* yr,
                                    float* yi, float* zr, float* zi, int b, int t, int c, int h,
                                    int w, int kt, int mode, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = static_cast<long>(h) * w;
  const int groups = b * kt, G = t * c / kt;  // slabs sharing one K
  const normal::Route r = normal::route(
      mode, normal::all_aligned16(xr, xi, kr, ki, sr, si, yr, yi, zr, zi, outr, outi), b, t, c, h,
      w, kt);
  if (r != normal::ENGINE) {
    const int err = normal::wgmma_contraction<Kernels>(r, xr, xi, sr, si, kr, ki, yr, yi, zr, zi, b,
                                                       t, c, h, w, kt, mode, s);
    return err ? err : reduce<4>(zr, zi, sr, si, xr, xi, lam, outr, outi, b, t, c, P, s);
  }
  if (yr == nullptr || yi == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      P % 4 == 0 && normal::all_aligned16(xr, xi, sr, si, yr, yi, zr, zi, outr, outi);
  int err = vec ? products<4>(xr, xi, sr, si, yr, yi, b, t, c, P, mode, s)
                : products<1>(xr, xi, sr, si, yr, yi, b, t, c, P, mode, s);
  if (err) return err;
  err = mode == 0   ? contraction<0>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s)
        : mode == 1 ? contraction<3>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s)
                    : contraction<1>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s);
  if (err) return err;
  return vec ? reduce<4>(zr, zi, sr, si, xr, xi, lam, outr, outi, b, t, c, P, s)
             : reduce<1>(zr, zi, sr, si, xr, xi, lam, outr, outi, b, t, c, P, s);
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
