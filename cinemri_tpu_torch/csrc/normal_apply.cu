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
// is bound by the FP32 rate at 'highest' (0.1446 ms at 67 TFLOP/s). The
// Pallas program keeps a whole (h, w) plane, K and the coil stack on chip
// (about 8 MB); a block has 227 KB of shared memory.
//
// Design: for one frame the contraction over all coils is one complex
// product, K_t (h x h) · [S_1⊙x_t | … | S_C⊙x_t] (h x c·w); at the flagship
// 15 of them. At 'highest' a call launches three kernels (the engine route
// of normal_wgmma.cuh):
// (a) the products y = S_c ⊙ x_t into a (b·t·c, h, w) scratch (48 MB at the
//     flagship), one memory pass;
// (b) z = K_t ·_h y on the tile engine (cgemm_tile.cuh: cp.async ring, 8 x 5
//     complex outputs a thread), row tiles clipped at frame boundaries so
//     that each block reads one K; on 16-byte rows its instance Fp32Tile
//     (normal_passes.cuh: 96 slab columns x 40 rows, 16-deep chunks, four
//     blocks an SM, 2.98 waves at the flagship);
// (c) out = Σ_c conj(S_c) ⊙ z_c + λx, one memory pass reading z once.
// On an NVIDIA H100 80GB HBM3 at 700 W at the flagship a call takes 0.328 ms
// device alone, 0.287 of it the contraction, against the FP32 bound of
// 0.1446 ms (PERF.md: kernel_ab.py, chip_smoke.py [precision]); one
// complex64 matmul of the contraction takes 0.240. Summing the coils in
// (b)'s epilogue would need a tile per frame holding every coil, or atomics,
// whose order is not deterministic.
// Where the caller asks for it (normal_cuda.set_fp32_tile('fused')), 16-byte
// rows take the fused route instead: one kernel for (a) and (b), the FP32
// tile of fp32_hopper.cuh (persistent blocks over all of h, S_c ⊙ x_t formed
// in its staging, y never in device memory), then (c). Its outputs are the
// engine route's, bit for bit; it is slower on the H100, 0.431 ms a call
// (fp32_hopper.cuh says why).
//
// The TF32 modes run (b) on the Hopper tile of wgmma_tf32.cuh. At 'default'
// the resident tile stages x_t and S_c (raw, by cp.async) and forms y =
// S_c ⊙ x_t while rounding its A, one operation at a time, once per element,
// so a call launches two kernels, the contraction with its products and (c).
// At 'high' the products' hi and lo would not fit a resident A, and
// streaming x and S per 40-column tile doubles the L2 traffic of streaming
// y (on an H100: 0.55 ms against the three kernels' 0.30 at the flagship), so
// (a) stays and (b) runs on the streaming tile (three kernels). Rows that
// are not 16-byte aligned keep the engine route in every mode: (a), the
// contraction on the tile engine (cgemm_tile.cuh at 'highest', the mma.sync
// tile of cgemm_tf32.cuh in the TF32 modes) and (c). The Hopper routes are
// shared with the backward's two contractions (normal_wgmma.cuh).

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

// 'highest' on the fused route: z[f, c] = K_g ·_h (S_c ⊙ x_f) on the FP32
// tile of fp32_hopper.cuh, the products formed in its staging.
__global__ void __launch_bounds__(fp32::MAX_THREADS, 1)
normal_apply_fp32_fused_kernel(const __grid_constant__ fp32::Problem p) {
  fp32::run(p);
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
  using TL = std::conditional_t<PASSES == 0, normal::Fp32Tile, tf32::Large>;
  using TS = std::conditional_t<PASSES == 0, cgemm::Small, tf32::Small>;
  return normal::tile_vec(h, w, kr, ki, yr, yi, zr, zi)
             ? normal::launch_contract<TL, false, normal_apply_contract_kernel<TL, 4, PASSES>>(
                   yr, yi, kr, ki, zr, zi, groups, G, h, w, s)
             : normal::launch_contract<TS, false, normal_apply_contract_kernel<TS, 1, PASSES>>(
                   yr, yi, kr, ki, zr, zi, groups, G, h, w, s);
}

// This file's kernels on the routes of normal_wgmma.cuh.
struct Kernels {
  static int fused(const fp32::Problem& p, cudaStream_t s) {
    return fp32::launch<normal_apply_fp32_fused_kernel>(p, s);
  }
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

// The route of a call (normal_wgmma.cuh: 0 the engine, 1 the products pass
// and the streaming TF32 tile, 2 the resident TF32 tile with the products
// fused, 3 the FP32 tile with the products fused, where `fused` asks for it
// at 'highest'), for the caller's operands and an output and scratch that
// the caller allocates (16-byte aligned): which scratch the call needs.
extern "C" int cinemri_normal_apply_route(const float* xr, const float* xi, const float* kr,
                                          const float* ki, const float* sr, const float* si, int b,
                                          int t, int c, int h, int w, int kt, int mode, int fused) {
  return normal::route(mode, fused != 0, normal::all_aligned16(xr, xi, kr, ki, sr, si), b, t, c, h,
                       w, kt);
}

// yr, yi, zr, zi: scratch of b·t·c·h·w floats each, allocated by the caller
// (yr and yi unused, and may be null, on routes 2 and 3).
// mode: 0 'highest', 1 'high', 2 'default'; fused: 1 for the fused FP32
// route at 'highest' (route 3 on 16-byte rows), else 0.
extern "C" int cinemri_normal_apply(const float* xr, const float* xi, const float* kr,
                                    const float* ki, const float* sr, const float* si,
                                    const float* lam, float* outr, float* outi, float* yr,
                                    float* yi, float* zr, float* zi, int b, int t, int c, int h,
                                    int w, int kt, int mode, int fused, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = static_cast<long>(h) * w;
  const int groups = b * kt, G = t * c / kt;  // slabs sharing one K
  const normal::Route r = normal::route(
      mode, fused != 0, normal::all_aligned16(xr, xi, kr, ki, sr, si, yr, yi, zr, zi, outr, outi),
      b, t, c, h, w, kt);
  if (r != normal::ENGINE) {
    const int err = normal::hopper_contraction<Kernels>(r, xr, xi, sr, si, kr, ki, yr, yi, zr, zi,
                                                        b, t, c, h, w, kt, mode, s);
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
