"""Timed inference runner producing the reference's .npy artifact set.

Counterpart of ``cinemri_tpu/cli/inference.py``. Parity target: reference
traintest_scripts/run_inference.py:13-82 — for each inference volume: a
timed model forward (the reference's only latency benchmark), a zero-filled
RSS baseline reconstruction, center-crop alignment, and ``target_*.npy`` /
``output_{model}_*.npy`` / ``zero_filled_*.npy`` dumps consumed by the
visualization (``cli/visualize.py``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from cinemri_tpu_torch.data.transforms import center_crop_to_smallest
from cinemri_tpu_torch.serve import bind_model

__all__ = ["InferenceRunner", "zero_filled_recon", "reconstruct_long_clip"]


def reconstruct_long_clip(
    forward,
    masked_kspace: np.ndarray,
    mask: np.ndarray,
    chunk_frames: int = 15,
) -> np.ndarray:
    """Reconstruct a clip longer than the trained temporal extent.

    The reference handles long cine clips offline by splitting them into
    15-frame chunks and concatenating the reconstructions
    (reconstruction_visualisation.ipynb cell 0 text / cell 2). Same recipe:
    ``forward(masked_kspace_chunk, mask_chunk) -> (b, tc, h, w)`` is called
    per chunk (a trailing short chunk is left-extended so every call has the
    trained extent) and outputs are stitched along t.

    Args:
        forward: callable over numpy complex k-space (b, t, c, h, w) and
            mask (b, t|1, 1, h, 1) returning an array-like image.
    """
    t = masked_kspace.shape[1]
    if t <= chunk_frames:
        return np.asarray(forward(masked_kspace, mask))
    outs = []
    static_mask = mask.shape[1] == 1
    for start in range(0, t, chunk_frames):
        end = min(start + chunk_frames, t)
        lo = end - chunk_frames  # left-extend the final short chunk
        k_chunk = masked_kspace[:, lo:end]
        m_chunk = mask if static_mask else mask[:, lo:end]
        out = np.asarray(forward(k_chunk, m_chunk))
        outs.append(out[:, start - lo :])
    return np.concatenate(outs, axis=1)


def zero_filled_recon(masked_kspace: np.ndarray) -> np.ndarray:
    """Zero-filled RSS baseline (run_inference.py:64-67): unnormalized IFFT
    rescaled by sqrt(h*w), then RSS over coils. Host-side numpy (this is a
    save-path artifact, not a compute-path op)."""
    h, w = masked_kspace.shape[-2:]
    images = np.fft.fftshift(
        np.fft.ifft2(np.fft.ifftshift(masked_kspace, axes=(-2, -1))), axes=(-2, -1)
    ) * np.sqrt(h * w)
    return np.sqrt((np.abs(images) ** 2).sum(axis=2))


class InferenceRunner:
    """Runs a trained model over the inference split and saves artifacts.

    The weights are bound once at construction through
    :func:`cinemri_tpu_torch.serve.bind_model` (``state_dict`` loaded into
    ``model`` when given; ``None`` keeps the model's own). ``device``
    defaults to CUDA and raises without a CUDA device. With ``write`` off
    the runner only reconstructs: on a ``plane`` or ``coil`` mesh every rank
    of the group runs the request, and one writes the files.
    """

    def __init__(self, model, state_dict: Optional[Mapping[str, torch.Tensor]], model_type: str,
                 save_path: Path, device=None, write: bool = True):
        assert model_type in ("varnet", "cinenet", "xpdnet"), "Wrong model_type arg."
        self.model_type = model_type
        self.save_path = Path(save_path)
        self.write = write
        if write:
            self.save_path.mkdir(parents=True, exist_ok=True)
        self._serve = bind_model(model, state_dict, device=device)
        self._device = next(model.parameters()).device

    def __call__(self, batch: Dict) -> float:
        """Returns the request's wall-clock seconds (on the card, up to a
        ``torch.cuda.synchronize()`` after it)."""
        k = np.asarray(batch["masked_kspace"])
        args = [k.real, k.imag, batch["mask"]]
        if self.model_type == "cinenet":
            s = np.asarray(batch["sens_maps"])
            args += [s.real, s.imag]

        t0 = time.perf_counter()
        output = self._serve(*args)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        elapsed = time.perf_counter() - t0
        if not self.write:
            return elapsed

        target = np.asarray(batch["target"], np.float32)
        output = output.cpu().numpy().astype(np.float32)
        zero_filled = np.asarray(zero_filled_recon(k), np.float32)

        target, output = center_crop_to_smallest(target, output)
        target, zero_filled = center_crop_to_smallest(target, zero_filled)

        fname = batch["fname"][0]
        np.save(self.save_path / f"target_{fname}.npy", target[0])
        np.save(self.save_path / f"output_{self.model_type}_{fname}.npy", output[0])
        np.save(self.save_path / f"zero_filled_{fname}.npy", zero_filled[0])
        return elapsed
