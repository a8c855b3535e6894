"""A convolution's FLOP: 2 per multiply-add of its kernel over its output.

``cost([input, weight, output])`` with the input ``(n, cin, *s_in)``, the
weight ``(cout, cin, *k)`` and the output ``(n, cout, *s_out)``; bytes read
and written once. A transposed convolution is ``cost`` of its weight
``(cin, cout, *k)`` over its input: :func:`transposed`.
"""

import math

OP = "aten::convolution"


def cost(shapes):
    x, wgt, y = shapes
    flop = 2.0 * y[0] * math.prod(y[1:]) * math.prod(wgt[1:])
    return flop, 4.0 * (math.prod(x) + math.prod(wgt) + math.prod(y))


def transposed(shapes):
    x, wgt, y = shapes
    flop = 2.0 * x[0] * math.prod(x[1:]) * math.prod(wgt[1:])
    return flop, 4.0 * (math.prod(x) + math.prod(wgt) + math.prod(y))
