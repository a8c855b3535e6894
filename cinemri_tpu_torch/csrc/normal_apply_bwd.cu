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
// 1, 'high', 3xTF32 and 2, 'default', 1xTF32 on the tensor cores. The
// products and the passes after the contractions stay f32 in every mode.
//
// What bounds it on the H100: two h-contractions per coil, 16·t·c·h·h·w
// FLOP (19.2 GFLOP at t=15, c=10, h=w=200) against about 30 MB of inputs
// and outputs: the FP32 rate at 'highest' (0.2899 ms at 67 TFLOP/s); the TF32
// rate at 'default' (0.039 ms at 495 TFLOP/s) and 'high' (3 passes, 0.12 ms).
//
// Design: at 'highest' a call launches eight kernels on three (b·t·c, h, w)
// scratch pairs (144 MB at the flagship) and the (b·kt, h, h) copy Kᴴ (the
// engine route of normal_wgmma.cuh):
// 1. Kᴴ, the conjugate-transposed copy of K (normal_apply_bwd_adjoint_kernel,
//    a few µs of memory time): the FP32 tiles read B's rows along k;
// 2. v = S ⊙ g into the products scratch;
// 3. ȳ = Kᴴ ·_h v on the tile engine (Fp32Tile of normal_passes.cuh on
//    16-byte rows);
// 4. y = S ⊙ x into the products scratch (v is consumed);
// 5. z = K ·_h y, the same kernel;
// 6. x̄_t = Σ_c conj(S_c) ⊙ ȳ_c + λg, the forward's coil reduction;
// 7. s̄_c = Σ_t conj(g_t) ⊙ z_{t,c} + ȳ_{t,c} ⊙ conj(x_t): a thread owns
//    four pixels of one coil and sums over the frames in registers. The
//    Pallas kernel sums s̄ into an output block that stays resident across
//    the TPU's sequential grid; here no per-frame partials and no atomics
//    are needed, and the sum is deterministic;
// 8. λ̄'s partials, one block per (b, t).
// With the copy the tile's chains are those of a conjugated read of K (br
// = Re K, bi = −Im K, and the FMAs' sign flips are exact), so ȳ has the
// bits of a ȳ that reads Kᴴ in place. On an NVIDIA H100 80GB HBM3 at 700 W
// at the flagship a call takes 0.690 ms device alone, 0.287 + 0.285 of it
// the two contractions, against the FP32 bound of 0.2899 ms (PERF.md:
// kernel_ab.py, chip_smoke.py [precision]). Passes 6 and 7
// read ȳ twice (one more 48 MB pass) and keep b·c·h·w / 4 threads busy. One
// pass per pixel over t and c, holding s̄ for every coil in registers, would
// read ȳ once, but has b·h·w threads of ~200 registers: too few warps to
// cover the memory latency, and it measured slower than the two passes
// together on the H100.
// Where the caller asks for it (normal_cuda.set_fp32_tile('fused')), 16-byte
// rows take the fused route instead: steps 2-3 and 4-5 each one kernel on
// the FP32 tile of fp32_hopper.cuh, which forms S ⊙ g and S ⊙ x in its
// staging (six kernels a call, no products scratch); the same bits, slower
// on the H100, 0.894 ms a call (fp32_hopper.cuh says why).
//
// The TF32 modes take the same steps on the TF32 tiles of wgmma_tf32.cuh
// (normal_wgmma.cuh): at 'default', where the resident tile fills the card,
// each contraction forms its products in the tile's staging (6 kernels a
// call, no products scratch); at 'high', and on grids the resident tile
// does not fill, the steps above on the streaming tile (8 kernels).
// cvt.rna and the hi/lo split commute with negation, so rounding the copy's
// conj(K) gives the bits of the plain version's tf32(conj K): kernel and
// emulation differ in summation order only.
//
// Rows that are not 16-byte aligned: steps 2-8 with the two contractions on
// the tile engines (normal_passes.cuh): at 'highest' cgemm_tile.cuh's with
// ȳ on the copy Kᴴ (step 1, eight kernels); in the TF32 modes the mma.sync
// tile of cgemm_tf32.cuh with Kᴴ read in place as a conjugated,
// column-contiguous B (seven kernels).

#include <type_traits>

#include "normal_wgmma.cuh"

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

// The TF32 modes' contractions on the Hopper tile (normal_wgmma.cuh):
// z[f, c] = B_g ·_h y[f, c] from the products' scratch ('high'), with B = K
// or its conjugate-transposed copy Kᴴ.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
normal_apply_bwd_wgmma_kernel(const wgmma::Problem p) {
  wgmma::run<T>(p);
}

// 'default': the same with the products S_c ⊙ u_f formed in the staging of
// the resident tile (h ≤ 224).
template <class R>
__global__ void __launch_bounds__(R::THREADS, 1)
normal_apply_bwd_wgmma_resident_kernel(const wgmma::Problem p) {
  wgmma::run_resident<R>(p);
}

// 'highest' on the fused route: z[f, c] = B_g ·_h (S_c ⊙ u_f), B = K or the
// copy Kᴴ, on the FP32 tile of fp32_hopper.cuh, the products formed in its
// staging.
__global__ void __launch_bounds__(fp32::MAX_THREADS, 1)
normal_apply_bwd_fp32_fused_kernel(const __grid_constant__ fp32::Problem p) {
  fp32::run(p);
}

// Kᴴ of each of the b·kt matrices K (H x H): kh[g][i][k] = conj(K[g][k][i]),
// the B of ȳ's contraction at 'highest' and on the Hopper tiles. A block moves one 32 x 32 tile
// through shared memory (rows of 33 floats: the transposed reads hit distinct
// banks), reading and writing whole rows of 32 floats.
constexpr int ADJ_TILE = 32, ADJ_THREADS = 256;

__global__ void __launch_bounds__(ADJ_THREADS)
normal_apply_bwd_adjoint_kernel(const float* __restrict__ kr, const float* __restrict__ ki,
                                float* __restrict__ khr, float* __restrict__ khi, int H) {
  __shared__ float tr[ADJ_TILE][ADJ_TILE + 1], ti[ADJ_TILE][ADJ_TILE + 1];
  const long base = static_cast<long>(blockIdx.z) * H * H;
  const int tx = threadIdx.x % ADJ_TILE, ty = threadIdx.x / ADJ_TILE;
  const int r0 = blockIdx.y * ADJ_TILE, c0 = blockIdx.x * ADJ_TILE;  // K's rows r0.., columns c0..
  for (int j = ty; j < ADJ_TILE; j += ADJ_THREADS / ADJ_TILE) {
    const int r = r0 + j, col = c0 + tx;
    if (r < H && col < H) {
      tr[j][tx] = kr[base + static_cast<long>(r) * H + col];
      ti[j][tx] = ki[base + static_cast<long>(r) * H + col];
    }
  }
  __syncthreads();
  for (int j = ty; j < ADJ_TILE; j += ADJ_THREADS / ADJ_TILE) {
    const int r = c0 + j, col = r0 + tx;  // Kᴴ[r][col] = conj(K[col][r])
    if (r < H && col < H) {
      khr[base + static_cast<long>(r) * H + col] = tr[tx][j];
      khi[base + static_cast<long>(r) * H + col] = -ti[tx][j];
    }
  }
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

// The contraction with B (ADJOINT: B = Kᴴ read in place) on the mode's
// tile engine: the FP32 tiles (PASSES 0; B = K or the copy Kᴴ, never read in
// place) or the TF32 tiles (1, 3).
template <bool ADJOINT, int PASSES>
int contract_in(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
                float* zi, int groups, int G, int h, int w, bool wide, cudaStream_t s) {
  static_assert(PASSES != 0 || !ADJOINT, "'highest' contracts with the copy Kᴴ");
  using TL = std::conditional_t<PASSES == 0, normal::Fp32Tile, tf32::Large>;
  using TS = std::conditional_t<PASSES == 0, cgemm::Small, tf32::Small>;
  return wide ? contract<TL, 4, ADJOINT, PASSES>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s)
              : contract<TS, 1, ADJOINT, PASSES>(yr, yi, kr, ki, zr, zi, groups, G, h, w, s);
}

template <bool ADJOINT>
int contraction(const float* yr, const float* yi, const float* kr, const float* ki, float* zr,
                float* zi, int groups, int G, int h, int w, bool wide, int mode, cudaStream_t s) {
  if constexpr (ADJOINT) {  // the TF32 modes only
    return mode == 1 ? contract_in<true, 3>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s)
                     : contract_in<true, 1>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s);
  } else {
    return mode == 0   ? contract_in<false, 0>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s)
           : mode == 1 ? contract_in<false, 3>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s)
                       : contract_in<false, 1>(yr, yi, kr, ki, zr, zi, groups, G, h, w, wide, s);
  }
}

// This file's kernels on the routes of normal_wgmma.cuh.
struct Kernels {
  static int fused(const fp32::Problem& p, cudaStream_t s) {
    return fp32::launch<normal_apply_bwd_fp32_fused_kernel>(p, s);
  }
  template <class T>
  static int streaming(const wgmma::Problem& p, cudaStream_t s) {
    return wgmma::launch<T, normal_apply_bwd_wgmma_kernel<T>>(p, s);
  }
  template <class R>
  static int resident(const wgmma::Problem& p, cudaStream_t s) {
    return wgmma::launch_resident<R, normal_apply_bwd_wgmma_resident_kernel<R>>(p, s);
  }
  template <int VEC, bool UNFUSED, class... Args>
  static int products(long n, cudaStream_t s, Args... args) {
    return normal::launch_pass<normal_apply_bwd_products_kernel<VEC, UNFUSED>>(n, s, args...);
  }
};

// kh = Kᴴ for the `groups` matrices K (h x h)
int adjoint(const float* kr, const float* ki, float* khr, float* khi, int groups, int h,
            cudaStream_t s) {
  const unsigned tiles = (h + ADJ_TILE - 1) / ADJ_TILE;
  if (tiles == 0 || groups == 0) return 0;
  return cgemm::launch<normal_apply_bwd_adjoint_kernel>(dim3(tiles, tiles, groups), ADJ_THREADS, 0,
                                                        s, kr, ki, khr, khi, h);
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

// The route of a call (normal_wgmma.cuh: 0 the engine, 1 the products pass
// and the streaming TF32 tile, 2 the resident TF32 tile with the products
// fused, 3 the FP32 tile with the products fused, where `fused` asks for it
// at 'highest'), for the caller's operands and outputs and scratch that the
// caller allocates (16-byte aligned): which scratch the call needs.
extern "C" int cinemri_normal_apply_bwd_route(const float* xr, const float* xi, const float* gr,
                                              const float* gi, const float* kr, const float* ki,
                                              const float* sr, const float* si, int b, int t,
                                              int c, int h, int w, int kt, int mode, int fused) {
  return normal::route(mode, fused != 0, normal::all_aligned16(xr, xi, gr, gi, kr, ki, sr, si), b,
                       t, c, h, w, kt);
}

// Scratch allocated by the caller: pr, pi, ybr, ybi, zr, zi of b·t·c·h·w
// floats each (pr and pi unused, and may be null, on routes 2 and 3), and
// khr, khi of b·kt·h·h floats each on routes 1-3 and at 'highest' (else
// unused, may be null).
// mode: 0 'highest', 1 'high', 2 'default'; fused: 1 for the fused FP32
// route at 'highest' (route 3 on 16-byte rows), else 0.
extern "C" int cinemri_normal_apply_bwd(const float* xr, const float* xi, const float* gr,
                                        const float* gi, const float* kr, const float* ki,
                                        const float* sr, const float* si, const float* lam,
                                        float* xbr, float* xbi, float* sbr, float* sbi, float* lb,
                                        float* pr, float* pi, float* ybr, float* ybi, float* zr,
                                        float* zi, float* khr, float* khi, int b, int t, int c,
                                        int h, int w, int kt, int mode, int fused, void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long P = static_cast<long>(h) * w;
  const int groups = b * kt, G = t * c / kt;  // slabs sharing one K
  const normal::Route r =
      normal::route(mode, fused != 0,
                    normal::all_aligned16(xr, xi, gr, gi, kr, ki, sr, si, pr, pi, ybr, ybi, zr, zi,
                                          khr, khi, xbr, xbi, sbr, sbi),
                    b, t, c, h, w, kt);
  if (r != normal::ENGINE) {
    if (khr == nullptr || khi == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // ȳ = Kᴴ ·_h (S ⊙ g), on the copy Kᴴ; z = K ·_h (S ⊙ x)
    int err = adjoint(kr, ki, khr, khi, groups, h, s);
    if (!err)
      err = normal::hopper_contraction<Kernels>(r, gr, gi, sr, si, khr, khi, pr, pi, ybr, ybi, b,
                                                t, c, h, w, kt, mode, s);
    if (!err)
      err = normal::hopper_contraction<Kernels>(r, xr, xi, sr, si, kr, ki, pr, pi, zr, zi, b, t,
                                                c, h, w, kt, mode, s);
    return err ? err
               : passes<4>(xr, xi, gr, gi, sr, si, lam, xbr, xbi, sbr, sbi, lb, ybr, ybi, zr, zi, b,
                           t, c, P, s);
  }
  if (pr == nullptr || pi == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0 && (khr == nullptr || khi == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = P % 4 == 0 && normal::all_aligned16(xr, xi, gr, gi, sr, si, pr, pi, ybr, ybi,
                                                        zr, zi, xbr, xbi, sbr, sbi);
  // 1-3: ȳ = Kᴴ ·_h (S ⊙ g), at 'highest' on the copy Kᴴ, else Kᴴ read in place
  int err = mode == 0 ? adjoint(kr, ki, khr, khi, groups, h, s) : 0;
  if (err) return err;
  err = vec ? products<4>(gr, gi, sr, si, pr, pi, b, t, c, P, mode, s)
            : products<1>(gr, gi, sr, si, pr, pi, b, t, c, P, mode, s);
  if (err) return err;
  err = mode == 0 ? contraction<false>(pr, pi, khr, khi, ybr, ybi, groups, G, h, w,
                                       normal::tile_vec(h, w, khr, khi, pr, pi, ybr, ybi), mode, s)
                  : contraction<true>(pr, pi, kr, ki, ybr, ybi, groups, G, h, w,
                                      normal::tile_vec(h, w, kr, ki, pr, pi, ybr, ybi), mode, s);
  if (err) return err;
  // 4-5: z = K ·_h (S ⊙ x)
  err = vec ? products<4>(xr, xi, sr, si, pr, pi, b, t, c, P, mode, s)
            : products<1>(xr, xi, sr, si, pr, pi, b, t, c, P, mode, s);
  if (err) return err;
  err = contraction<false>(pr, pi, kr, ki, zr, zi, groups, G, h, w,
                           normal::tile_vec(h, w, kr, ki, pr, pi, zr, zi), mode, s);
  if (err) return err;
  // 6-8: x̄, s̄ and λ̄'s partials
  return vec ? passes<4>(xr, xi, gr, gi, sr, si, lam, xbr, xbi, sbr, sbi, lb, ybr, ybi, zr, zi, b,
                         t, c, P, s)
             : passes<1>(xr, xi, gr, gi, sr, si, lam, xbr, xbi, sbr, sbi, lb, ybr, ybi, zr, zi, b,
                         t, c, P, s);
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
