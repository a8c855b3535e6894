"""``cinemri::normal_apply(xr, xi, kr, ki, sr, si, lam, ...)``:
``Σ_c conj(S_c) ⊙ (K_t ·_h (S_c ⊙ x_t)) + λx``.

The h-contraction per coil, the products around it and ``+ λx``; reads x,
K, S, writes the output (λ's four bytes left out).
"""

OP = "cinemri::normal_apply"


def cost(shapes):
    b, t, h, w = shapes[0]
    kt, c = shapes[2][1], shapes[4][1]
    flop = 8.0 * b * t * c * h * h * w + 14.0 * b * t * c * h * w + 4.0 * b * t * h * w
    return flop, 8.0 * (2 * b * t * h * w + b * kt * h * h + b * c * h * w)
