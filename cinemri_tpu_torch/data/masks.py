"""Cartesian undersampling mask generators.

A numpy-only copy of ``cinemri_tpu/data/masks.py`` (the port imports nothing
of the JAX package); the same seed gives the same mask in both packages.
Parity target: reference reconstruction/data/subsample.py:31-235.

  * :class:`RandomMask` — GRAPPA-style per-frame random line masks drawn
    from a tail-adjusted Gaussian pdf (subsample.py:75-151, after Schlemper
    et al.). ``center_lines`` is a *count* of always-sampled central lines
    (the reference overloads the name ``center_fractions`` for this —
    subsample.py:42-44; renamed here per SURVEY §7 "unify semantics").
  * :class:`EquispacedMask` — one static equispaced mask with an
    exact-acceleration offset; ``center_fraction`` is a true *fraction*
    (subsample.py:154-215).

Seeding: each generator owns a ``numpy.random.RandomState``. The reference
draws the (center, acceleration) choice from the instance RNG but the random
line selection from the **global** ``np.random`` (subsample.py:139), so its
``use_seed`` path never actually fixes the sampled lines. Here *all* draws
come from the instance RNG (or the per-call seed), making seeded masks fully
reproducible — a deliberate, documented fix (SURVEY §7, quirks list).

Masks are host-side numpy (they're input-pipeline work, regenerated per
sample), shaped for the framework's complex layout:
``(t, 1, h, 1)`` float32 for random masks, ``(1, 1, h, 1)`` for equispaced —
broadcastable against k-space ``(t, c, h, w)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["MaskFunc", "RandomMask", "EquispacedMask", "create_mask_for_mask_type"]

Seed = Optional[Union[int, Tuple[int, ...]]]


class MaskFunc:
    """Base: uniformly picks one (center, acceleration) pair per call."""

    def __init__(self, center_fractions: Sequence[float], accelerations: Sequence[int]):
        if len(center_fractions) != len(accelerations):
            raise ValueError(
                "Number of center fractions should match number of accelerations"
            )
        self.center_fractions = list(center_fractions)
        self.accelerations = list(accelerations)
        self.rng = np.random.RandomState()

    def _rng_for(self, seed: Seed) -> np.random.RandomState:
        if seed is None:
            return self.rng
        return np.random.RandomState(seed)

    def choose_acceleration(self, rng: np.random.RandomState):
        choice = rng.randint(0, len(self.accelerations))
        return self.center_fractions[choice], self.accelerations[choice]

    def __call__(self, num_frames: int, num_rows: int, seed: Seed = None) -> np.ndarray:
        raise NotImplementedError


class RandomMask(MaskFunc):
    """Per-frame random Cartesian line mask (subsample.py:75-151).

    For each of ``num_frames`` frames independently: always sample
    ``center_lines`` central rows; sample the remaining
    ``num_rows/acceleration - center_lines`` rows without replacement from
    ``pdf(i) ∝ exp(-0.5/(N/10)^2 · (i - N/2)^2) + N/(2·acc)/N`` with the
    central band zeroed out (subsample.py:118-147).
    """

    def __call__(self, num_frames: int, num_rows: int, seed: Seed = None) -> np.ndarray:
        rng = self._rng_for(seed)
        center_lines_f, acc = self.choose_acceleration(rng)
        sample_n = int(center_lines_f)
        nx = num_rows

        i = np.arange(nx)
        pdf_x = np.exp(-(0.5 / (nx / 10.0) ** 2) * (i - nx / 2) ** 2)
        lmda = nx / (2.0 * acc)
        n_lines = int(nx / acc)
        pdf_x = pdf_x + lmda / nx

        if sample_n:
            pdf_x[nx // 2 - sample_n // 2 : nx // 2 + sample_n // 2] = 0
            n_lines -= sample_n
        if n_lines < 0:
            # the reference crashes inside np.random.choice here with
            # "Negative dimensions are not allowed"; fail with the cause
            raise ValueError(
                f"center_lines={sample_n} exceeds the sampling budget "
                f"{nx}/{acc}={int(nx / acc)} lines for {nx} rows at "
                f"acceleration {acc}"
            )
        # the reference only normalizes when sample_n > 0 (subsample.py:133),
        # which makes center_lines=0 crash np.random.choice; normalizing
        # unconditionally is identical otherwise.
        pdf_x = pdf_x / pdf_x.sum()

        mask = np.zeros((num_frames, nx), dtype=np.float32)
        for f in range(num_frames):
            idx = rng.choice(nx, n_lines, replace=False, p=pdf_x)
            mask[f, idx] = 1
        if sample_n:
            mask[:, nx // 2 - sample_n // 2 : nx // 2 + sample_n // 2] = 1

        return mask.reshape(num_frames, 1, nx, 1)


class EquispacedMask(MaskFunc):
    """Static equispaced mask, shared by all frames (subsample.py:154-215)."""

    def __call__(self, num_frames: int, num_rows: int, seed: Seed = None) -> np.ndarray:
        rng = self._rng_for(seed)
        center_fraction, acceleration = self.choose_acceleration(rng)
        num_low_freqs = int(round(num_rows * center_fraction))

        mask = np.zeros(num_rows, dtype=np.float32)
        pad = (num_rows - num_low_freqs + 1) // 2
        mask[pad : pad + num_low_freqs] = 1

        # adjust spacing so the overall rate hits the target acceleration
        # given the dense center (subsample.py:199-206)
        adjusted_accel = (acceleration * (num_low_freqs - num_rows)) / (
            num_low_freqs * acceleration - num_rows
        )
        offset = rng.randint(0, round(adjusted_accel))
        accel_samples = np.arange(offset, num_rows - 1, adjusted_accel)
        mask[np.around(accel_samples).astype(np.uint32)] = 1

        return mask.reshape(1, 1, num_rows, 1)


def create_mask_for_mask_type(
    mask_type_str: str,
    center_fractions: Sequence[float],
    accelerations: Sequence[int],
) -> MaskFunc:
    """Factory matching the reference API (subsample.py:218-235)."""
    if mask_type_str == "random":
        return RandomMask(center_fractions, accelerations)
    if mask_type_str == "equispaced":
        return EquispacedMask(center_fractions, accelerations)
    raise ValueError(f"{mask_type_str} not supported")
