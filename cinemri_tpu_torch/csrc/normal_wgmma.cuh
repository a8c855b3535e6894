// The normal apply's h-contraction in the TF32 modes on the Hopper tile
// (wgmma_tf32.cuh), shared by the forward (csrc/normal_apply.cu) and both
// contractions of its backward (csrc/normal_apply_bwd.cu):
//
//   z[f, c] = B_g ·_h (S[b, c] ⊙ u[f])
//
// over the groups g of G slabs that share one B (h x h, k-contiguous rows):
// K in the forward and the backward's z = K·(S⊙x), the conjugate-transposed
// copy Kᴴ in the backward's ȳ = Kᴴ·(S⊙g) (TF32 wgmma reads its shared
// operands K-major only, so Kᴴ reaches it as rows conj(K[:, i])). The route
// of a call (route() below):
// - RESIDENT, 'default' on grids of 64-row tiles that fill the card: one
//   kernel, the resident tile, which stages u and S raw and forms S ⊙ u while
//   rounding its A, once per element; no products pass, no y scratch;
// - STREAMING, 'high' and the 'default' grids the resident tile does not
//   fill: the products pass into the y scratch (no FMA contraction, as the
//   plain version rounds), then the streaming tile;
// - ENGINE, 'highest' and rows that are not 16-byte aligned: the tile
//   engines of normal_passes.cuh, launched by each file itself.
// Each file hands in its own __global__ kernels (Kernels: static launchers
// streaming<T>, resident<R> and products<VEC, UNFUSED>), so that every kernel
// carries its file's name, which the profiler fold (instrument/opstats.py)
// reads.

#pragma once

#include "normal_passes.cuh"
#include "wgmma_tf32.cuh"

namespace normal {

enum Route { ENGINE = 0, STREAMING = 1, RESIDENT = 2 };

using ResidentTile = wgmma::Resident<wgmma::FUSED>;

inline bool all_aligned16() { return true; }
template <class... Ps>
bool all_aligned16(const void* p, Ps... ps) {
  return cgemm::aligned16(p) && all_aligned16(ps...);
}

// The route of a call at `mode` (0 'highest', 1 'high', 2 'default') whose
// operand pointers are all 16-byte aligned (`aligned`), with K (b, kt, h, h)
// and (b·t·c, h, w) slabs.
inline Route route(int mode, bool aligned, int b, int t, int c, int h, int w, int kt) {
  if (mode == 0 || !aligned || h % 4 != 0 || w % 4 != 0) return ENGINE;
  const long M = static_cast<long>(t) * c / kt * w;  // slab columns of a group
  return mode == 2 && wgmma::resident_fills<ResidentTile>(M, h, b * kt) ? RESIDENT : STREAMING;
}

// z = B ·_h (S ⊙ u) on a route STREAMING or RESIDENT (y unused by RESIDENT).
template <class Kernels>
int wgmma_contraction(Route r, const float* ur, const float* ui, const float* sr, const float* si,
                      const float* br, const float* bi, float* yr, float* yi, float* zr, float* zi,
                      int b, int t, int c, int h, int w, int kt, int mode, cudaStream_t s) {
  const int groups = b * kt, G = t * c / kt;
  const long M = static_cast<long>(G) * w;
  if (r == RESIDENT)
    return Kernels::template resident<ResidentTile>(
        wgmma::Problem{ur, ui, sr, si, br, bi, zr, zi, M, h, w, c, t, groups}, s);
  if (yr == nullptr || yi == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long P = static_cast<long>(h) * w, n = static_cast<long>(b) * t * c * (P / 4);
  int err = Kernels::template products<4, true>(n, s, ur, ui, sr, si, yr, yi, t, c, P, n);
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
