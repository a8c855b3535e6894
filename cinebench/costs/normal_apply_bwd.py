"""``cinemri::normal_apply_bwd(xr, xi, gr, gi, kr, ki, sr, si, lam, ...)``.

Two h-contractions per coil (``ȳ = Kᴴ(S⊙g)`` and the recomputed ``z =
K(S⊙x)``), the elementwise products around them (36 FLOP per (b, t, c, h,
w) element), ``x̄ + λg`` and ``λ̄``; reads x, g, K, S, writes x̄, s̄ and the
(b, t) partials of λ̄.
"""

OP = "cinemri::normal_apply_bwd"


def cost(shapes):
    b, t, h, w = shapes[0]
    kt, c = shapes[4][1], shapes[6][1]
    flop = 16.0 * b * t * c * h * h * w + 36.0 * b * t * c * h * w + 8.0 * b * t * h * w
    return flop, 4.0 * (6 * b * t * h * w + 2 * b * kt * h * h + 4 * b * c * h * w + b * t)
