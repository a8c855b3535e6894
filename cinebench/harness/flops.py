"""The model's FLOP in closed form from the configuration's shapes, and the
card's published peaks.

A forward counts its convolutions and transposed convolutions, its DFTs,
the per-frame normal kernels (one complex ``h x h`` product per frame) and
its normal applies, each by the op costs under ``costs/``, so the count is
the same whatever implements them. Instance norm, pooling, activations and
the elementwise work are left out. A train step counts three forwards: the
backward twice the forward, the rematerialized replay not at all.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["PEAKS", "peaks", "op_cost", "cost_ops", "unet_flop", "pad16", "dft_flop", "dft2_flop",
           "kernel_flop", "normal_apply_flop", "forward_flop", "item_flop"]

# Published peaks (NVIDIA data sheets, dense): float32 outside the tensor
# cores in FLOP/s and device memory in bytes/s, matched against
# torch.cuda.get_device_name(0), first match wins.
PEAKS = (
    ("H100 NVL", 60.0e12, 3.9e12),
    ("H100 PCIe", 51.0e12, 2.0e12),
    ("H100", 67.0e12, 3.35e12),  # SXM
)


def peaks(device_name: str) -> Tuple[float, float]:
    for key, flops, bw in PEAKS:
        if key in device_name:
            return flops, bw
    raise ValueError(f"no published float32 and memory peak known for {device_name!r}")


def op_cost(op: str):
    """``costs/<op>.py``'s ``cost`` function."""
    return importlib.import_module(f"cinebench.costs.{op}").cost


def cost_ops() -> Dict[str, str]:
    """``{op name in a trace: costs module}`` of every ``costs/<op>.py``."""
    ops = {}
    for path in sorted((Path(__file__).resolve().parents[1] / "costs").glob("[!_]*.py")):
        ops[importlib.import_module(f"cinebench.costs.{path.stem}").OP] = path.stem
    return ops


def unet_flop(n: int, size: Tuple[int, int], chans: int, pools: int, cin: int = 2,
              cout: int = 2) -> float:
    """A 2-D U-Net over ``n`` planes of ``size`` (padding included)."""
    from cinebench.costs import conv

    def c3(ci, co, s):
        return conv.cost([(n, ci, *s), (co, ci, 3, 3), (n, co, *s)])[0]

    sizes = [tuple(size)]
    for _ in range(pools):
        sizes.append(tuple(x // 2 for x in sizes[-1]))
    flop, ch, ci = 0.0, chans, cin
    for level in range(pools):
        flop += c3(ci, ch, sizes[level]) + c3(ch, ch, sizes[level])
        ci, ch = ch, ch * 2
    flop += c3(ci, ch, sizes[pools]) + c3(ch, ch, sizes[pools])
    for level in range(pools - 1, -1, -1):
        s_in, s_out = sizes[level + 1], sizes[level]
        flop += conv.transposed([(n, ch, *s_in), (ch, ch // 2, 2, 2),
                                 (n, ch // 2, *(2 * x for x in s_in))])[0]
        ch //= 2
        flop += c3(2 * ch, ch, s_out) + c3(ch, ch, s_out)
    return flop + conv.cost([(n, ch, *sizes[0]), (cout, ch, 1, 1), (n, cout, *sizes[0])])[0]


def pad16(x: int) -> int:
    """``x`` padded up to a multiple of 16, as the normalized U-Net pads."""
    return -(-x // 16) * 16


def dft_flop(o: int, n: int, i: int) -> float:
    """One centered DFT of length ``n`` along the middle axis of ``(o, n, i)``."""
    return op_cost("dft_matmul")([(o, n, i)])[0]


def dft2_flop(lead: int, h: int, w: int) -> float:
    """A centered 2-D DFT of ``(lead, h, w)``: along h, then along w."""
    return dft_flop(lead, h, w) + dft_flop(lead * h, w, 1)


def kernel_flop(t: int, h: int) -> float:
    """The per-frame normal kernels ``W_i · (diag(m) W_f)``, one complex
    ``h x h`` product a frame."""
    return 8.0 * t * h ** 3


def normal_apply_flop(t: int, c: int, h: int, w: int) -> float:
    """One normal apply on a volume, per-frame kernels."""
    return op_cost("normal_apply")([(1, t, h, w), (), (1, t, h, h), (), (1, c, h, w)])[0]


def forward_flop(cfg: dict) -> float:
    """One volume's forward: the reference family's own count
    (``reference/<family>.py::flop``)."""
    from cinebench.reference import family

    return family(cfg).flop(cfg)


def item_flop(cfg: dict, kind: str) -> float:
    """One item of a traffic kind: a served volume, or a train step."""
    return forward_flop(cfg) * (3 if kind == "train" else 1)
