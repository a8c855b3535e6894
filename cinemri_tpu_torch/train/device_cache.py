"""Device-resident cache of per-sample training constants.

Counterpart of ``cinemri_tpu/train/device_cache.py``. Cine training re-reads
the same volumes every epoch; only the undersampling mask changes per
(epoch, volume) (the reference's per-epoch random masking,
transforms.py:327-330). So the per-sample constants (raw k-space, target,
stable sensitivity maps) live on the Trainer's device for the whole run,
each step sends only the mask, and the masked k-space is rebuilt on the
device as ``k * mask + 0.0`` (``train/loop.py``). At the protocol shape a
step then sends a few KB instead of the ~48 MB masked k-space (15 x 10 x
200 x 200 complex64).

The cache is LRU-bounded by a device byte budget. The Trainer keeps one for
the train loader and one for the evaluation loaders, each with its own
budget, so an evaluation pass never evicts the train samples.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from cinemri_tpu_torch.ops.cplx import Complex

__all__ = ["DeviceSampleCache", "to_device"]


def to_device(value, device: torch.device):
    """A host array on ``device`` (complex as a float32 :class:`Complex`
    pair, real as float32) and the bytes it took there."""
    value = np.asarray(value)
    if np.iscomplexobj(value):
        re = torch.from_numpy(np.ascontiguousarray(value.real, dtype=np.float32)).to(device)
        im = torch.from_numpy(np.ascontiguousarray(value.imag, dtype=np.float32)).to(device)
        return Complex(re, im), re.nbytes + im.nbytes
    placed = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32)).to(device)
    return placed, placed.nbytes


class DeviceSampleCache:
    """LRU map: hashable key -> dict of device tensors (:class:`Complex`
    for complex inputs), bounded by total device bytes."""

    def __init__(self, device, budget_bytes: int = 4 << 30):
        self.device = torch.device(device)
        self.budget = int(budget_bytes)
        self._entries: "OrderedDict[Tuple, Tuple[int, Dict]]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.bytes_sent = 0  # host -> device, every miss

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key, build: Callable[[], Dict[str, np.ndarray]]) -> Dict:
        """Return the device dict for ``key``, sending ``build()``'s host
        arrays to the device on a miss (``None`` values stay ``None``)."""
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return hit[1]
        dev: Dict[str, object] = {}
        nbytes = 0
        for name, value in build().items():
            if value is None:
                dev[name] = None
                continue
            dev[name], n = to_device(value, self.device)
            nbytes += n
        self.misses += 1
        self.bytes_sent += nbytes
        self._entries[key] = (nbytes, dev)
        self._bytes += nbytes
        while self._bytes > self.budget and len(self._entries) > 1:
            _, (freed, _dropped) = self._entries.popitem(last=False)
            self._bytes -= freed
        return dev
