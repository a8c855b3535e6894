"""The program under test, ``cinemri_tpu_torch``, through its own entry points.

This is the only module of the benchmark that imports the program, and it
takes from it only the system under test: its kernel build
(``ops.kernels._build.build``), ``models.build_model``,
``serve.bind_model``, ``train.step.create_train_state`` /
``make_train_step`` and ``ops.fft.set_dft_precision``. Everything is
imported inside the functions, so the harness's tests import this module
without the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

__all__ = ["build_kernels", "build", "bind", "train_state", "train_batch", "first_moments"]


def build_kernels() -> List[str]:
    """Build the program's kernel libraries that its cache lacks, all at
    once (``_build.build``); returns the names built, empty when every one
    was found built."""
    from cinemri_tpu_torch.ops.kernels import _build

    return sorted(name for name, r in _build.build().items() if not r["hit"])


def build(cfg: dict, device) -> torch.nn.Module:
    """The configuration's model on ``device`` through ``build_model`` with
    the configuration's ``model`` keywords, at its DFT precision; the caller sets its parameters
    (``load_state_dict``) to the benchmark's draw."""
    from cinemri_tpu_torch.models import build_model
    from cinemri_tpu_torch.ops.fft import set_dft_precision

    set_dft_precision(cfg["dft_precision"])
    return build_model(cfg["family"], cfg["dynamic_type"], device=device, **cfg["model"])


def bind(model: torch.nn.Module, device) -> Callable:
    """``serve(k_re, k_im, mask[, s_re, s_im]) -> image`` (``serve.bind_model``)."""
    from cinemri_tpu_torch.serve import bind_model

    return bind_model(model, device=device)


def train_state(model: torch.nn.Module, opt: dict, device):
    """``(state, step)``: ``create_train_state`` with the traffic's optimizer
    settings and ``make_train_step()``."""
    from cinemri_tpu_torch.train.step import create_train_state, make_train_step

    state = create_train_state(model, device=device, lr=opt["lr"], lr_step_size=opt["lr_step_size"],
                               lr_gamma=opt["lr_gamma"], steps_per_epoch=opt["steps_per_epoch"])
    return state, make_train_step()


def train_batch(vol: dict, with_maps: bool) -> dict:
    """A volume as a batch of ``make_train_step``'s format, on the volume's device."""
    from cinemri_tpu_torch.ops.cplx import Complex

    k = vol["kspace"]
    batch = {"masked_kspace": Complex(k.real.contiguous(), k.imag.contiguous()),
             "mask": vol["mask"], "target": vol["target"]}
    if with_maps:
        s = vol["maps"]
        batch["sens_maps"] = Complex(s.real.contiguous(), s.imag.contiguous())
    return batch


def first_moments(state) -> Dict[str, torch.Tensor]:
    """Adam's first moment of each parameter by name (absent before a step)."""
    adam = state.optimizer.adam
    return {n: adam.state[p]["exp_avg"] for n, p in state.model.named_parameters()
            if "exp_avg" in adam.state.get(p, {})}
