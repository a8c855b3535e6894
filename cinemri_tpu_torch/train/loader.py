"""Host-side batching over the datasets.

A numpy copy of ``cinemri_tpu/train/loader.py``: batches stay numpy on the
host and cross to the device in the Trainer (``train/loop.py``), never here.

Replaces the reference's torch DataLoader + worker processes + per-worker
RNG seeding (data_module.py:18-61,134-204). Batches are dicts of stacked
numpy arrays (device placement and sharding happen in the trainer); mask
RNGs are seeded deterministically per (base_seed, epoch, rank) instead of
per worker process. Eval splits use volume-aware sharding so whole volumes
stay on one worker (the VolumeSampler contract).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from cinemri_tpu_torch.data.sharding import data_shard_indices, volume_shard_indices

__all__ = ["Loader", "collate", "prefetch"]


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, keeping ``size`` items ready.

    The decode path (HDF5 read or cache read + mask generation) overlaps
    with device compute — the role of the reference's 4 DataLoader worker
    processes (data_module.py:196-202), without process-fork overhead
    (decoding is numpy, which releases the GIL for the heavy parts).
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item

_STACK_KEYS = ("masked_kspace", "mask", "target", "sens_maps")


def collate(samples: List[Dict], n_valid: int | None = None) -> Dict:
    """Stack sample dicts into one batch dict.

    ``n_valid``: number of leading samples that are real data; trailing
    entries are padding (repeats of the last real sample) and get
    ``sample_weight`` 0 so they contribute nothing to the training loss
    (the reference's DataLoader emits a smaller final batch instead).
    """
    batch: Dict = {}
    for k in _STACK_KEYS:
        if k in samples[0]:
            batch[k] = np.stack([s[k] for s in samples])
    batch["fname"] = [s["fname"] for s in samples]
    batch["slice_num"] = np.asarray([s["slice_num"] for s in samples])
    batch["max_value"] = np.asarray([s["max_value"] for s in samples], np.float32)
    n_valid = len(samples) if n_valid is None else n_valid
    batch["sample_weight"] = (np.arange(len(samples)) < n_valid).astype(np.float32)
    return batch


class Loader:
    """Deterministic epoch-based batch iterator over a SliceDataset."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_replicas: int = 1,
        rank: int = 0,
        volume_aware: bool = False,
        seed: int = 42,
        drop_last: bool = False,
        bucket_by_shape: bool = True,
        prefetch_size: int = 2,
        num_workers: int = 1,
    ):
        """``bucket_by_shape``: reorder each epoch so consecutive batches are
        homogeneous in (coil count, encoding size). Real cine archives mix
        coil counts across volumes, and a batch stacks samples of one
        shape, so bucketing keeps every batch stackable instead of failing
        mid-batch (SURVEY §7 hard part #6: bucket-and-pad).

        ``num_workers``: decode-thread pool size (the reference's 4
        DataLoader worker processes, data_module.py:196-202). At 1, samples
        decode serially in the prefetch thread and masks draw sequentially
        from the transform's per-epoch-seeded RNG (round-2 behavior). At
        >1, decodes run concurrently — HDF5/numpy and the CineNet eigh
        release the GIL — and each sample's mask uses its own seed derived
        from (seed, epoch, rank, position), so batches stay deterministic
        regardless of thread completion order (different draws than the
        serial stream, equally random)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_replicas = num_replicas
        self.rank = rank
        self.volume_aware = volume_aware
        self.seed = seed
        self.drop_last = drop_last
        self.bucket_by_shape = bucket_by_shape
        self.prefetch_size = prefetch_size
        self.num_workers = max(int(num_workers), 1)

    def _indices(self, epoch: int) -> List[int]:
        if self.volume_aware and self.num_replicas > 1:
            return volume_shard_indices(
                self.dataset.examples,
                self.num_replicas,
                self.rank,
                shuffle=self.shuffle,
                seed=self.seed,
                epoch=epoch,
            )
        return data_shard_indices(
            len(self.dataset),
            self.num_replicas,
            self.rank,
            shuffle=self.shuffle,
            seed=self.seed,
            epoch=epoch,
            drop_last=self.drop_last,
        )

    def steps_per_epoch(self) -> int:
        return len(self._batch_chunks(0))

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        it = self._epoch_iter(epoch)
        if self.prefetch_size > 0:
            return prefetch(it, self.prefetch_size)
        return it

    def _epoch_iter(self, epoch: int) -> Iterator[Dict]:
        # reseed per-epoch mask RNG deterministically (the reference's
        # worker_init_fn analogue, data_module.py:18-61)
        tr = getattr(self.dataset, "transform", None)
        if tr is not None and getattr(tr, "mask_func", None) is not None:
            tr.mask_func.rng.seed((self.seed + 1009 * epoch + self.rank) % (2**32 - 1))

        if self.num_workers > 1 and hasattr(self.dataset, "load"):
            yield from self._parallel_epoch_iter(epoch)
            return
        for chunk, n_valid in self._batch_chunks(epoch):
            yield collate([self.dataset[j] for j in chunk], n_valid)

    def _parallel_epoch_iter(self, epoch: int) -> Iterator[Dict]:
        """Thread-pool decode with a bounded in-flight window; batches are
        yielded in order. Per-sample mask seeds make results independent of
        scheduling (see ``num_workers`` docstring)."""
        from concurrent.futures import ThreadPoolExecutor

        chunks = self._batch_chunks(epoch)
        jobs = [j for chunk, _ in chunks for j in chunk]
        # unique seed per (epoch, rank, flat sample position); fname-seeded
        # transforms (use_seed=True) keep their own deterministic draw — it
        # is already scheduling-independent
        tr = getattr(self.dataset, "transform", None)
        if tr is not None and getattr(tr, "use_seed", False):
            flat_seeds = [None] * len(jobs)
        else:
            flat_seeds = [
                (self.seed + 1009 * epoch + 7919 * self.rank + 104729 * p) % (2**31 - 1)
                for p in range(len(jobs))
            ]
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window = self.num_workers * 2 + self.batch_size
            futures = []
            submitted = 0
            taken = 0

            def top_up():
                nonlocal submitted
                while submitted < len(jobs) and (submitted - taken) < window:
                    futures.append(
                        pool.submit(
                            self.dataset.load, jobs[submitted],
                            mask_seed=flat_seeds[submitted],
                        )
                    )
                    submitted += 1

            top_up()
            for chunk, n_valid in chunks:
                samples = []
                for _ in chunk:
                    samples.append(futures[taken].result())
                    futures[taken] = None  # free memory
                    taken += 1
                    top_up()
                yield collate(samples, n_valid)

    def _shape_key(self, i: int):
        examples = getattr(self.dataset, "examples", None)
        if examples is None or not hasattr(examples[i], "metadata"):
            return ()
        md = examples[i].metadata
        return (
            md.get("num_coils", 0),
            md.get("encoding_size", ()),
            md.get("num_frames", 0),
        )

    def _batch_chunks(self, epoch: int) -> List:
        """(index chunk, n_valid) pairs of size batch_size, shape-homogeneous.

        Buckets are chunked independently so a batch never straddles two
        shapes; each bucket's trailing partial batch is padded by repeating
        its own last sample (unless drop_last). ``n_valid`` counts the real
        samples so collate can zero the padding's loss weight."""
        idx = self._indices(epoch)
        if self.bucket_by_shape and len(idx) > 1:
            buckets: Dict = {}
            for i in idx:  # preserves shuffled order within each bucket
                buckets.setdefault(self._shape_key(i), []).append(i)
            groups = list(buckets.values())
        else:
            groups = [list(idx)]

        chunks: List = []
        for group in groups:
            if self.drop_last:
                group = group[: (len(group) // self.batch_size) * self.batch_size]
            for i in range(0, len(group), self.batch_size):
                chunk = list(group[i : i + self.batch_size])
                if not chunk:
                    continue
                n_valid = len(chunk)
                if n_valid < self.batch_size:
                    chunk = chunk + [chunk[-1]] * (self.batch_size - n_valid)
                chunks.append((chunk, n_valid))
        return chunks

    def first_batch(self) -> Dict:
        """One batch for shape/compile purposes, bypassing the prefetch
        thread (abandoning a prefetch generator would leak its worker and
        double-decode the first samples)."""
        chunks = self._batch_chunks(0)
        if not chunks:
            raise ValueError("empty dataset")
        chunk, n_valid = chunks[0]
        return collate([self.dataset[j] for j in chunk], n_valid)
