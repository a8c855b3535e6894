"""Import reference PyTorch/Lightning checkpoints into the port.

Counterpart of ``cinemri_tpu/interop/torch_import.py``. The reference saves
standard pytorch-lightning checkpoints: a dict with ``state_dict`` (tensor
tree, keys prefixed by the pl-module attribute — ``varnet.`` / ``cinenet.``
/ ``xpdnet.``, varnet_module.py:82, cinenet_module.py:74,
xpdnet_module.py:114) and ``hyper_parameters`` (``save_hyperparameters()``,
varnet_module.py:57). A user of the reference loads a trained ``.ckpt``
here and gets the port's state dict plus the ``build_model`` kwargs that
rebuild the architecture.

Route: the flat state dict is parsed back into a pseudo-module tree (dots
-> attributes, integer segments -> list indices), which the weight movers
of :mod:`cinemri_tpu_torch.interop.port` turn into the JAX package's
flax-layout tree, exactly as the JAX package imports it; then
:mod:`cinemri_tpu_torch.interop.flax_params` gives the port's state dict.
Every step moves or transposes values, so the result is bit-identical to
the JAX package's import carried over by ``flax_params``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

import torch

from . import flax_params, port

FAMILIES = ("varnet", "cinenet", "xpdnet")


# ------------------------------------------------------- pseudo-module tree


class _Leaf:
    """A checkpoint tensor posing as a torch Parameter for the movers."""

    def __init__(self, arr: np.ndarray):
        self._arr = arr

    def detach(self) -> "_Leaf":
        return self

    def numpy(self) -> np.ndarray:
        return self._arr

    @property
    def shape(self):
        return self._arr.shape


class _Node:
    """A state-dict subtree posing as a torch module / ModuleList."""

    def __init__(self):
        self._children: dict[str, Any] = {}

    # -- construction
    def _insert(self, parts: list[str], arr: np.ndarray) -> None:
        head = parts[0]
        if len(parts) == 1:
            self._children[head] = _Leaf(arr)
            return
        child = self._children.setdefault(head, _Node())
        if not isinstance(child, _Node):  # pragma: no cover - malformed dict
            raise ValueError(f"key conflict at {head!r}")
        child._insert(parts[1:], arr)

    # -- module-like access
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._children[name]
        except KeyError:
            raise AttributeError(name) from None

    def has(self, name: str) -> bool:
        return name in self._children

    # -- ModuleList/Sequential-like access (integer keys; may be sparse —
    # parameterless entries like ReLU/InstanceNorm leave index gaps)
    def _items(self):
        return sorted(
            ((int(k), v) for k, v in self._children.items() if k.isdigit())
        )

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [v for _, v in self._items()][idx]
        if isinstance(idx, int) and idx < 0:  # e.g. first_convs[-1]
            return [v for _, v in self._items()][idx]
        return self._children[str(idx)]

    def __len__(self) -> int:
        return len(self._items())

    def __iter__(self):
        return iter(v for _, v in self._items())

    def is_list(self) -> bool:
        return bool(self._children) and all(k.isdigit() for k in self._children)


def tree_from_state_dict(state_dict: dict) -> _Node:
    """Parse a flat ``name.sub.0.weight -> tensor`` dict into a _Node tree."""
    root = _Node()
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy() if hasattr(val, "detach") else np.asarray(val)
        root._insert(key.split("."), arr)
    return root


def _scalar(leaf) -> np.float32:
    """lambda_reg is a shape-(1,) torch Parameter (varnet.py:176-179)."""
    return np.float32(np.asarray(leaf.detach().numpy()).reshape(-1)[0])


# ------------------------------------------------------------ family mappers


def _plane_nets(model_node, dynamic_type: str, weight_sharing: bool, mover) -> dict:
    """The per-cascade denoiser params, named per this framework's modules
    (varnet.py:125-165, cinenet.py:85-109): XF/XT get a plane pair (or one
    shared ``plane_net``), 2D/3D a single ``net``."""
    if dynamic_type in ("XF", "XT"):
        if weight_sharing:
            return {"plane_net": mover(model_node)}
        return {"net_xf": mover(model_node[0]), "net_yf": mover(model_node[1])}
    return {"net": mover(model_node)}


def varnet_params_tree(net: _Node, dynamic_type: str, weight_sharing: bool) -> dict:
    """reference VarNet / VarNet_RNN state tree -> flax params dict."""
    if net.has("bcrnn"):  # VarNet_RNN (recurrent_varnet.py:13-150)
        return {
            "sens_net": port.sens_model_params(net.sens_net),
            "iterations": {
                "trunk": port.crnn_trunk_params(net),
                "lambda_reg": _scalar(net.lambda_reg),
            },
        }
    lam = np.asarray(
        [_scalar(blk.lambda_reg) for blk in net.cascades], np.float32
    )
    return {
        "sens_net": port.sens_model_params(net.sens_net),
        "cascades": _plane_nets(
            net.model, dynamic_type, weight_sharing, port.norm_unet_params
        ),
        "lambda_reg": lam,
    }


def cinenet_params_tree(net: _Node, dynamic_type: str, weight_sharing: bool) -> dict:
    """reference CineNet / CineNet_RNN state tree -> flax params dict."""
    if net.has("bcrnn"):  # CineNet_RNN (recurrent_cinenet.py:12-187)
        return {
            "iterations": {
                "trunk": port.crnn_trunk_params(net),
                "lambda_reg": _scalar(net.lambda_reg),
            }
        }
    lam = np.asarray(
        [_scalar(blk.lambda_reg) for blk in net.cascades], np.float32
    )
    return {
        "cascades": _plane_nets(
            net.model, dynamic_type, weight_sharing, port.unet_params
        ),
        "lambda_reg": lam,
    }


def xpdnet_params_tree(net: _Node, dynamic_type: str, weight_sharing: bool) -> dict:
    """reference XPDNet / XPDNet_RNN state tree -> flax params dict.

    Unrolled XPDNet carries per-cascade MWCNNs (xpdnet.py:264-276) which this
    framework scans over stacked params — per-cascade trees are stacked along
    axis 0. ``kspace_net`` appears only when primal_only=False
    (xpdnet.py:239-248; the primal-only path is a parameterless residual).
    """
    sens = {"Unet_0": port.unet_params(net.sens_net.unet_model)}
    if net.has("bcrnn"):  # XPDNet_RNN (recurrent_xpdnet.py:14-239)
        return {"sens_net": sens, "iterations": {"trunk": port.crnn_trunk_params(net)}}

    per_cascade = []
    for i in range(len(net.image_net)):
        entry = net.image_net[i]
        if entry.is_list():  # XF/XT pair, weight_sharing=False
            cas = {
                "image_net_xf": port.mwcnn_params(entry[0]),
                "image_net_yf": port.mwcnn_params(entry[1]),
            }
        else:
            cas = {"image_net": port.mwcnn_params(entry)}
        if net.has("kspace_net"):
            cas["kspace_net"] = port.kspace_cnn_params(net.kspace_net[i])
        per_cascade.append(cas)

    return {"sens_net": sens, "cascades": _stack(per_cascade)}


def _stack(trees: list) -> dict:
    """Stack equal-structured trees leaf by leaf along a new axis 0 (the
    flax scan's cascade axis)."""
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


_MAPPERS = {
    "varnet": varnet_params_tree,
    "cinenet": cinenet_params_tree,
    "xpdnet": xpdnet_params_tree,
}

# the flax-layout tree -> the port's state dict: (unrolled, CRNN)
_STATE_DICTS = {
    "varnet": (flax_params.varnet_state_dict, flax_params.varnet_rnn_state_dict),
    "cinenet": (flax_params.cinenet_state_dict, flax_params.cinenet_rnn_state_dict),
    "xpdnet": (flax_params.xpdnet_state_dict, flax_params.xpdnet_rnn_state_dict),
}


# --------------------------------------------------------------- public API


def build_kwargs_from_hparams(family: str, hparams: dict, dynamic_type: str) -> dict:
    """Translate reference pl-module hyper_parameters into ``build_model``
    kwargs (varnet_module.py:23-56, cinenet_module.py:23-55,
    xpdnet_module.py:22-101 signatures)."""
    hp = dict(hparams)
    crnn = dynamic_type == "CRNN"
    if family == "varnet":
        keys = {"num_cascades", "chans", "sens_chans", "sens_pools"}
        if not crnn:
            keys |= {"pools", "weight_sharing"}
    elif family == "cinenet":
        keys = {"num_cascades", "chans"}
        if not crnn:
            keys |= {"pools", "weight_sharing"}
        if "CG_iters" in hp:
            hp["cg_iters"] = hp.pop("CG_iters")
        keys |= {"cg_iters"}
    elif family == "xpdnet":
        if crnn:
            if "crnn_chans" in hp:
                hp["chans"] = hp.pop("crnn_chans")
            keys = {"num_cascades", "sens_chans", "sens_pools", "chans", "n_primal"}
        else:
            keys = {
                "num_cascades", "sens_chans", "sens_pools", "n_scales",
                "n_filters_per_scale", "n_convs_per_scale", "n_first_convs",
                "first_conv_n_filters", "n_primal", "primal_only", "n_dual",
                "res", "weight_sharing",
            }
    else:
        raise ValueError(f"unknown family {family!r}")
    out = {k: hp[k] for k in keys if k in hp}
    for k in ("n_filters_per_scale", "n_convs_per_scale"):
        if k in out and isinstance(out[k], list):
            out[k] = tuple(out[k])
    return out


def import_torch_checkpoint(
    path,
    family: str | None = None,
    dynamic_type: str | None = None,
    weight_sharing: bool | None = None,
):
    """Load a reference checkpoint file into this framework.

    Accepts a full Lightning checkpoint (``{"state_dict", "hyper_parameters",
    ...}``, as written by trainer.save_checkpoint — train_test_varnet.py:
    107-109) or a bare ``model.state_dict()``. Family is auto-detected from
    the ``varnet./cinenet./xpdnet.`` key prefix when present; ``dynamic_type``
    and ``weight_sharing`` come from the stored hyper_parameters unless
    overridden.

    Returns ``(state_dict, build_kwargs, family, dynamic_type)`` where
    ``state_dict`` loads into the model built by ``build_model(family,
    dynamic_type, **build_kwargs)`` (``load_state_dict``; CPU tensors).
    """
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:  # pickled hparams rejected: fall back to tensors only
        ckpt = torch.load(path, map_location="cpu", weights_only=True)

    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        state_dict = ckpt["state_dict"]
        hparams = dict(ckpt.get("hyper_parameters") or {})
    else:
        state_dict, hparams = ckpt, {}

    first = next(iter(state_dict))
    prefix = first.split(".", 1)[0]
    if prefix in FAMILIES:
        detected = prefix
        state_dict = {
            k.split(".", 1)[1]: v
            for k, v in state_dict.items()
            if k.startswith(prefix + ".")
        }
    else:
        detected = None
    family = family or detected
    if family is None:
        raise ValueError(
            f"cannot detect model family from state-dict keys (first: {first!r});"
            " pass family='varnet'|'cinenet'|'xpdnet'"
        )
    if detected is not None and family != detected:
        raise ValueError(f"checkpoint is a {detected} model, not {family}")

    net = tree_from_state_dict(state_dict)
    if dynamic_type is None:
        dynamic_type = "CRNN" if net.has("bcrnn") else hparams.get("dynamic_type", "XF")
    if weight_sharing is None:
        weight_sharing = bool(hparams.get("weight_sharing", False))

    tree = _MAPPERS[family](net, dynamic_type, weight_sharing)
    kwargs = build_kwargs_from_hparams(family, hparams, dynamic_type)
    if weight_sharing and dynamic_type in ("XF", "XT"):
        kwargs["weight_sharing"] = True
    state_dict = _STATE_DICTS[family][net.has("bcrnn")](tree)
    return state_dict, kwargs, family, dynamic_type


def check_tree_matches(state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise with a readable diff if an imported state dict's keys or shapes
    don't match ``model``'s: the first 5 missing, unexpected and
    shape-mismatched keys. Guards against importing a checkpoint into a
    mismatched ``build_model`` configuration."""
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if got == want:
        return
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    diff = sorted(p for p in set(got) & set(want) if got[p] != want[p])
    msgs = []
    if missing:
        msgs.append(f"missing from checkpoint: {missing[:5]}")
    if extra:
        msgs.append(f"unexpected in checkpoint: {extra[:5]}")
    if diff:
        msgs.append("shape mismatches: " + ", ".join(f"{p} {got[p]} != {want[p]}" for p in diff[:5]))
    raise ValueError("imported checkpoint does not match the model: " + "; ".join(msgs))
