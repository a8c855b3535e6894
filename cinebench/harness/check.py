"""The numbers that decide ``correct``, and their judgement against limits.

Serving: every image the window returned against the reference's image of
the same request, the worst request's relative L2 gap ``‖y − r‖ / ‖r‖`` and
relative widest gap ``max |y − r| / max |r|``.

Training: the three steps the reference follows. Each step's loss, as the
worst relative gap; the first step's gradient, as the optimizer got it, and
each parameter's change over the three steps, as norms per parameter: each
parameter's gap ``|‖a‖ − ‖r‖| / max(‖r‖, median over parameters of ‖r‖)``,
of which the worst parameter's (``grad_norm_gap``, ``change_norm_gap``) and,
for the gradient, the median parameter's (``grad_norm_gap_median``). The
change leaves out parameters whose reference gradient is under a thousandth
of the median parameter's, which Adam moves by round-off alone. A cell's
limits name the numbers it compares.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

__all__ = ["image_gaps", "norm_gaps", "train_gaps", "judge", "format_lines"]

GRAD_FLOOR = 1e-3  # reference gradient norm, as a share of the median parameter's


def image_gaps(outputs: Iterable[Tuple[int, torch.Tensor]], refs: Sequence[torch.Tensor]) -> dict:
    """``outputs`` ``(request's pool index, image)``; ``refs`` by pool index."""
    l2, widest = 0.0, 0.0
    scale = [(float(r.norm()), float(r.abs().max())) for r in refs]
    for k, y in outputs:
        d = (y.to(refs[k].dtype) - refs[k]).abs()
        l2 = max(l2, float(d.norm()) / scale[k][0])
        widest = max(widest, float(d.max()) / scale[k][1])
    return {"image_rel_l2": l2, "image_rel_max": widest}


def norm_gaps(got: Dict[str, float], want: Dict[str, float], names: Iterable[str]) -> List[float]:
    """Each parameter's norm gap (module docstring) over ``names``."""
    floor = statistics.median(want[n] for n in want)
    return [abs(got.get(n, 0.0) - want[n]) / max(want[n], floor) for n in names] or [0.0]


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each with ``losses`` (per step), ``grad_norms``
    and ``change_norms`` (by parameter name)."""
    losses = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= GRAD_FLOOR * median]
    grad = norm_gaps(prog["grad_norms"], grads, grads)
    change = norm_gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": losses,
            "grad_norm_gap": max(grad), "grad_norm_gap_median": statistics.median(grad),
            "change_norm_gap": max(change)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """Each value against its limit; ``correct`` when every one is finite and
    at most its limit."""
    lines = [{"name": n, "value": values[n], "limit": limits[n]} for n in limits]
    ok = all(math.isfinite(x["value"]) and x["value"] <= x["limit"] for x in lines)
    return ok, lines


def format_lines(lines: List[dict]) -> List[str]:
    return [f"{x['name']} {x['value']!r} limit {x['limit']!r}" for x in lines]
