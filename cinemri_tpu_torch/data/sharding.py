"""Volume-aware example sharding across data-parallel workers.

A numpy copy of ``cinemri_tpu/data/sharding.py``.

Parity target: reference reconstruction/data/volume_sampler.py:16-114
(a torch DistributedSampler variant). In the TPU framework there is no
sampler object wired into a DataLoader — sharding is a pure function the
host input pipeline applies to its example list before batching, per host
process (multi-host) or per device slot (single-host device batching). The
invariant is identical: **all slices of one volume land on the same worker**
so per-volume metric aggregation never crosses workers.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["volume_shard_indices", "data_shard_indices"]


def volume_shard_indices(
    examples: Sequence,
    num_replicas: int,
    rank: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
) -> List[int]:
    """Indices for ``rank``, keeping volumes whole, padded to equal length.

    Mirrors VolumeSampler: round-robin volumes over ranks by sorted name
    (volume_sampler.py:63-76), pad every rank to the max per-rank count by
    repeating from the front (:87-105), epoch-seeded shuffle (:92-98).
    """
    if not 0 <= rank < num_replicas:
        raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
    names = sorted({str(ex[0]) for ex in examples})
    split = [
        {names[i] for i in range(r, len(names), num_replicas)}
        for r in range(num_replicas)
    ]
    rank_indices: List[List[int]] = [[] for _ in range(num_replicas)]
    for i, ex in enumerate(examples):
        vname = str(ex[0])
        for r in range(num_replicas):
            if vname in split[r]:
                rank_indices[r].append(i)
                break
    num_samples = max(len(ix) for ix in rank_indices)

    indices = rank_indices[rank]
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(len(indices))
        indices = [indices[i] for i in order]
    if not indices:
        return []
    repeat = num_samples // len(indices)
    indices = indices * repeat + indices[: num_samples - len(indices) * repeat]
    assert len(indices) == num_samples
    return indices


def data_shard_indices(
    num_examples: int,
    num_replicas: int,
    rank: int,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = False,
) -> List[int]:
    """Plain strided example sharding (torch DistributedSampler analogue),
    used for the training split (data_module.py:189-194)."""
    order = np.arange(num_examples)
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(num_examples)
    if drop_last:
        total = (num_examples // num_replicas) * num_replicas
        order = order[:total]
    else:
        pad = (-len(order)) % num_replicas
        order = np.concatenate([order, order[:pad]]) if pad else order
    return list(order[rank::num_replicas])
