"""The host side of a window: the CPUs the process may use, its threads, and
the CPU seconds it spent in the window. Printed with the result (``host``),
so that a run whose host-paced numbers moved shows how its process ran.
The machine's own load is not read: in the card's sandbox ``/proc/stat`` and
the load average read a machine always busy, with no steal, at load 0.
"""

from __future__ import annotations

import os
import resource
from typing import Dict

__all__ = ["snapshot", "window_summary"]


def _threads() -> int:
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return 0


def snapshot() -> Dict[str, float]:
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"proc_cpu_s": usage.ru_utime + usage.ru_stime}


def window_summary(pair) -> Dict[str, float]:
    """The machine's CPUs, those the process may use, its threads and torch's
    CPU threads at the window's close, and the process's CPU seconds in the
    window (host-paced, about the window's length: its issuing thread never
    rests)."""
    import torch

    a, b = pair
    return {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
            "threads": _threads(), "torch_threads": torch.get_num_threads(),
            "proc_cpu_s": b["proc_cpu_s"] - a["proc_cpu_s"]}
