// The normal apply's h-contraction on 16-byte rows on the H100, shared by the
// forward (csrc/normal_apply.cu) and both contractions of its backward
// (csrc/normal_apply_bwd.cu):
//
//   z[f, c] = B_g ·_h (S[b, c] ⊙ u[f])
//
// over the groups g of G slabs that share one B (h x h, k-contiguous rows):
// K in the forward and the backward's z = K·(S⊙x), the conjugate-transposed
// copy Kᴴ in the backward's ȳ = Kᴴ·(S⊙g) (TF32 wgmma reads its shared
// operands K-major only, and the FP32 tiles read B's rows along k, so Kᴴ
// reaches them as rows conj(K[:, i])). The route of a call (route() below):
// - ENGINE, 'highest' by default, and rows that are not 16-byte aligned in
//   every mode: the products pass and the tile engines of normal_passes.cuh,
//   launched by each file itself (at 'highest' on 16-byte rows its
//   instance Fp32Tile);
// - FP32_FUSED, 'highest' where the caller asks for it: one kernel, the FP32
//   tile of fp32_hopper.cuh, which stages u and S raw and forms S ⊙ u in
//   its staging; no products pass, no y scratch;
// - RESIDENT, 'default' on grids of 64-row tiles that fill the card: one
//   kernel, the resident TF32 tile of wgmma_tf32.cuh, which stages u and S
//   raw and forms S ⊙ u while rounding its A, once per element; no products
//   pass, no y scratch;
// - STREAMING, 'high' and the 'default' grids the resident tile does not
//   fill: the products pass into the y scratch (no FMA contraction, as the
//   plain version rounds), then the streaming TF32 tile.
// Each file hands in its own __global__ kernels (Kernels: static launchers
// fused, streaming<T>, resident<R> and products<VEC, UNFUSED>), so that
// every kernel carries its file's name, which the profiler fold
// (instrument/opstats.py) reads.

#pragma once

#include "fp32_hopper.cuh"
#include "normal_passes.cuh"
#include "wgmma_tf32.cuh"

namespace normal {

enum Route { ENGINE = 0, STREAMING = 1, RESIDENT = 2, FP32_FUSED = 3 };

using ResidentTile = wgmma::Resident<wgmma::FUSED>;

inline bool all_aligned16() { return true; }
template <class... Ps>
bool all_aligned16(const void* p, Ps... ps) {
  return cgemm::aligned16(p) && all_aligned16(ps...);
}

// The route of a call at `mode` (0 'highest', 1 'high', 2 'default') whose
// operand pointers are all 16-byte aligned (`aligned`), with K (b, kt, h, h)
// and (b·t·c, h, w) slabs; `fused` asks for the FP32_FUSED route at 'highest'.
inline Route route(int mode, bool fused, bool aligned, int b, int t, int c, int h, int w,
                   int kt) {
  if (!aligned || h % 4 != 0 || w % 4 != 0) return ENGINE;
  if (mode == 0) return fused ? FP32_FUSED : ENGINE;
  const long M = static_cast<long>(t) * c / kt * w;  // slab columns of a group
  return mode == 2 && wgmma::resident_fills<ResidentTile>(M, h, b * kt) ? RESIDENT : STREAMING;
}

// z = B ·_h (S ⊙ u) on a route FP32_FUSED, STREAMING or RESIDENT (y
// unused by FP32_FUSED and RESIDENT).
template <class Kernels>
int hopper_contraction(Route r, const float* ur, const float* ui, const float* sr, const float* si,
                       const float* br, const float* bi, float* yr, float* yi, float* zr, float* zi,
                       int b, int t, int c, int h, int w, int kt, int mode, cudaStream_t s) {
  const int groups = b * kt, G = t * c / kt;
  const long M = static_cast<long>(G) * w;
  if (r == FP32_FUSED)
    return Kernels::fused(fp32::Problem{ur, ui, sr, si, br, bi, zr, zi, M, h, w, c, t, groups}, s);
  if (r == RESIDENT)
    return Kernels::template resident<ResidentTile>(
        wgmma::Problem{ur, ui, sr, si, br, bi, zr, zi, M, h, w, c, t, groups}, s);
  if (yr == nullptr || yi == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long P = static_cast<long>(h) * w, n = static_cast<long>(b) * t * c * (P / 4);
  // the TF32 modes round each product on its own, as the plain version does
  const int err = Kernels::template products<4, true>(n, s, ur, ui, sr, si, yr, yi, t, c, P, n);
  if (err) return err;
  const wgmma::Problem p{yr, yi, nullptr, nullptr, br, bi, zr, zi, M, h, w, 1, 1, groups};
  const bool wide = wgmma::wide_fills(M, h, groups);
  if (mode == 1)
    return wide ? Kernels::template streaming<wgmma::Wide<3, wgmma::SLAB>>(p, s)
                : Kernels::template streaming<wgmma::Narrow<3, wgmma::SLAB>>(p, s);
  return wide ? Kernels::template streaming<wgmma::Wide<1, wgmma::SLAB>>(p, s)
              : Kernels::template streaming<wgmma::Narrow<1, wgmma::SLAB>>(p, s);
}

}  // namespace normal
