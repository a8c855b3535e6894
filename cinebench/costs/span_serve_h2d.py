"""The program span ``cinemri.serve.h2d``: the request's copies to the device in serve(...).

A span, not an op: naming it here makes the op span's fold list its calls
with the device time and device events of the ops inside it
(``harness/spans.py``). It has no FLOP or bytes of its own.
"""

OP = "cinemri.serve.h2d"


def cost(shapes):
    raise TypeError(f"{OP} is a program span: it has no FLOP or bytes of its own")
