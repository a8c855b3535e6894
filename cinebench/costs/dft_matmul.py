"""``cinemri::dft_matmul(xr, xi, wr, wi, ...)``: ``y = W x`` along the middle
axis of an ``(O, N, I)`` view; reads x and W, writes y."""

OP = "cinemri::dft_matmul"


def cost(shapes):
    o, n, i = shapes[0]
    return 8.0 * o * n * n * i, 4.0 * (4 * o * n * i + 2 * n * n)
