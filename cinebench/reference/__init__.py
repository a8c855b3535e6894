"""Plain PyTorch reference of the benchmark's configurations.

Written from the models' equations in ``complex64`` with ``torch.fft``,
``torch.matmul`` / ``einsum`` and ``torch.nn.functional`` convolutions, in
float32 with TF32 off (:func:`full_f32`). It imports nothing of the program
and takes nothing the program made: the harness hands it the same weights
(by parameter name) and the same inputs it hands the program, and it works
out again the sensitivity maps, ``x_ref``, the per-frame normal kernels, the
data consistency, CineNet's CG solves, the SSIM loss and Adam.
"""

import importlib

__all__ = ["family", "forward", "train_steps", "full_f32", "tf32"]


def family(cfg: dict):
    """The configuration family's module, ``reference/<family>.py``, with
    ``forward(cfg, params, kspace, mask, maps)``, ``flop(cfg)`` and the
    ``DYNAMIC_TYPES`` it covers."""
    module = importlib.import_module(f"cinebench.reference.{cfg['family']}")
    if cfg["dynamic_type"] not in module.DYNAMIC_TYPES:
        raise ValueError(f"no reference of {cfg['family']} {cfg['dynamic_type']}")
    return module


def forward(cfg: dict, p: dict, k, mask, maps=None):
    """The configuration's image for one batch of requests."""
    return family(cfg).forward(cfg, p, k, mask, maps)


def train_steps(cfg: dict, params: dict, batches: list, opt: dict) -> dict:
    """:func:`cinebench.reference.train.train_steps`."""
    from cinebench.reference.train import train_steps as steps

    return steps(cfg, params, batches, opt)


def full_f32() -> None:
    """Float32 convolutions and matmuls in full float32 (no TF32)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32() -> None:
    """The control's precision: TF32 convolutions and matmuls."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
