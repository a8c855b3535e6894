"""Statistics of a window: percentiles over all requests, times per item
over the whole window."""

from __future__ import annotations

import statistics
from typing import Sequence

__all__ = ["percentile", "per_item_ms"]


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile (1..99) over all ``values``, by
    ``statistics.quantiles(..., n=100, method="inclusive")``."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def per_item_ms(items: int, seconds: float) -> float:
    """The window's milliseconds over the items completed in it."""
    return 1e3 * seconds / items
