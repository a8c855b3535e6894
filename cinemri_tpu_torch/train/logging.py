"""TensorBoard logging: scalars and cine videos.

Parity target: reference MriModule's observability (mri_module.py:96-144):
prog-bar scalars (``training_loss``/``validation_loss``/``test_loss``),
``{split}_metrics/{nmse,ssim,psnr}``, and fps=15 video logging of
target / reconstruction / |error| for selected batches, each normalized by
its own max. Backed by tensorboardX, imported only when a ``log_dir`` is
given. A copy of ``cinemri_tpu/train/logging.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["TrainLogger"]


class TrainLogger:
    def __init__(self, log_dir: Optional[Path], enabled: bool = True):
        self.enabled = enabled and log_dir is not None
        self._writer = None
        if self.enabled:
            from tensorboardX import SummaryWriter

            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._writer = SummaryWriter(str(log_dir))

    def scalars(self, values: Dict[str, float], step: int):
        if not self.enabled:
            return
        for k, v in values.items():
            self._writer.add_scalar(k, float(v), step)

    def cine_video(self, tag: str, target, output, step: int, fps: int = 15):
        """Log target / reconstruction / error videos (mri_module.py:96-111).

        target/output: (t, h, w) float arrays. tensorboardX encodes video via
        moviepy; when it is unavailable, fall back to a frame strip image so
        the qualitative log survives on minimal installs.
        """
        if not self.enabled:
            return
        target = np.asarray(target, np.float32)
        output = np.asarray(output, np.float32)
        error = np.abs(target - output)
        try:
            import moviepy  # noqa: F401

            has_moviepy = True
        except ImportError:
            has_moviepy = False
        for name, vid in (
            ("target", target),
            ("reconstruction", output),
            ("error", error),
        ):
            v = vid / max(float(vid.max()), 1e-12)
            if has_moviepy:
                # tensorboardX add_video wants (N, T, C, H, W) in [0, 1]
                self._writer.add_video(
                    f"{tag}/{name}", v[None, :, None, :, :], global_step=step, fps=fps
                )
            else:
                strip = np.concatenate(list(v), axis=1)  # (h, t*w)
                self._writer.add_image(
                    f"{tag}/{name}", strip[None], global_step=step
                )

    def flush(self):
        if self.enabled:
            self._writer.flush()

    def close(self):
        if self.enabled:
            self._writer.close()
