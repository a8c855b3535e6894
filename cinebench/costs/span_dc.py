"""The program span ``cinemri.dc``: a cascade's data consistency (VarNet's
soft DC; CineNet's right-hand side and CG solve).

A span, not an op: naming it here makes the op span's fold list its calls
with the device time and device events of the ops inside it
(``harness/spans.py``). It has no FLOP or bytes of its own.
"""

OP = "cinemri.dc"


def cost(shapes):
    raise TypeError(f"{OP} is a program span: it has no FLOP or bytes of its own")
