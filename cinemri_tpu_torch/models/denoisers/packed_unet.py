"""Space-to-depth ("packed") execution of the conv stacks.

Counterpart of ``cinemri_tpu/models/denoisers/packed_unet.py``: each level
of a U-Net (and the MWCNN's grid levels, the CRNN trunk) can run on a
representation that folds 2x2(x2) spatial blocks into the channel dim, with
the SAME parameters as the dense stack. The JAX package packs to widen its
16-channel activations toward the TPU's 128 lanes; on the GPU it is the
other shape of the same function (4-8x the channels on a 2-4x smaller
grid), held against the dense one on the card.

Layout: channels first, ``(n, c·B, *grid)`` for a block ``(b0, ..., bd-1)``
with ``B = Πbᵢ`` and ``grid = spatial / block``; packed channel
``c·B + phase``, c-major, the phase the row-major index of the offsets in
the block (dim 0 slowest). So a channel slice of whole logical channels is
the packing of that slice, and a packed concatenation is the packing of
the logical one. The 2-D square block is ``F.pixel_unshuffle``.

The transform is exact:

  * a k-SAME conv becomes a conv on the packed grid whose kernel is
    assembled from the logical one by a constant 0/1 phase map
    (:func:`_conv_phase_map`, the JAX package's array; each packed tap is a
    copy of at most one logical tap, so the assembly is a gather);
  * the k=2 s=2 transpose conv becomes a packed transpose conv of per-dim
    (kernel, stride) (2, 2) or (1, 1) (:func:`_convt_phase_map`, derived
    for torch's stored weight, ``y[2q + i] = W[i]·x[q]``; the JAX map is
    lax's flipped convention);
  * instance norm is group norm with one group per logical channel;
  * the 2x average pool is a mean over phase pairs in channel space, a
    crop-and-mean on the grid of unpacked dims (:func:`packed_avg_pool_2x`).

:class:`PackedConv` and :class:`PackedConvTranspose` are ``nn.Conv*`` /
``nn.ConvTranspose*`` modules with the dense modules' parameters (names,
shapes, init), run on a packed input given its block(s); with no block they
compute what the dense module computes. The constant maps are made once on
the host; their device copies are cached through ``ops.kernels.trace_safe``.
Convolutions and group norm are PyTorch/cuDNN ops, as the JAX package
wrote no Pallas kernel for them (a layout is not a kernel).

``dtype`` is the activation dtype (``models/denoisers/activations.py``): in
bf16 the assembled f32 kernel and the input are cast to bf16, the bias is
added after the convolution's rounding, and group norm takes f32
statistics, as in the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cinemri_tpu_torch.models.denoisers.activations import conv_in_dtype, instance_norm, is_reduced
from cinemri_tpu_torch.ops.kernels import trace_safe

__all__ = [
    "block_size",
    "choose_blocks",
    "pack",
    "unpack",
    "packed_conv",
    "packed_conv_transpose",
    "packed_group_norm",
    "packed_avg_pool_2x",
    "PackedConv",
    "PackedConv2d",
    "PackedConv3d",
    "PackedConvTranspose",
    "PackedConvTranspose2d",
    "PackedConvTranspose3d",
    "PACKED_CONV",
    "PACKED_CONV_T",
]

Block = Tuple[int, ...]


def block_size(block: Sequence[int]) -> int:
    return math.prod(block)


def choose_blocks(spatial: Sequence[int], chans: int, num_pool_layers: int,
                  target_lanes: int = 128, order: Sequence[int] | None = None) -> list:
    """Per-level blocks for a U-Net, the JAX package's rule.

    Level k has ``chans·2**k`` channels over ``spatial / 2**k``; each level
    packs dims (the trailing ones, w then h, first) while the packed width
    stays below ``target_lanes`` and the level's size divides the block.
    Blocks are 1, 2 or 4 per dim; between levels each dim's block is its
    parent's or half of it, so the decoder's transpose conv has a packed
    stride of 1 or 2."""
    d = len(spatial)
    order = list(order) if order is not None else list(range(d - 1, -1, -1))
    blocks = []
    sizes = list(spatial)
    ch = chans
    parent = None
    for level in range(num_pool_layers + 1):
        if parent is None:
            b = [1] * d
            eff = ch
            for cap in (2, 4):  # double in preference order, then escalate
                for dim in order:
                    if eff >= target_lanes:
                        break
                    if b[dim] * 2 <= cap and sizes[dim] % (b[dim] * 2) == 0:
                        eff //= b[dim]
                        b[dim] *= 2
                        eff *= b[dim]
        else:
            # at least half the parent's block per dim; raised toward the
            # parent's while below the target and the size divides
            b = [max(p // 2, 1) for p in parent]
            eff = ch * block_size(b)
            for dim in order:
                while eff < target_lanes and b[dim] * 2 <= parent[dim] and sizes[dim] % (b[dim] * 2) == 0:
                    b[dim] *= 2
                    eff *= 2
        for dim in range(d):
            if sizes[dim] % b[dim]:
                raise ValueError(f"level {level}: size {sizes[dim]} not divisible by mandatory "
                                 f"block {b[dim]} (dim {dim})")
        blocks.append(tuple(b))
        parent = tuple(b)
        sizes = [s // 2 for s in sizes]
        ch *= 2
    return blocks


def _square2d(block: Block) -> bool:
    return len(block) == 2 and block[0] == block[1]


def pack(x: torch.Tensor, block: Block) -> torch.Tensor:
    """``(n, c, *spatial)`` -> ``(n, c·B, *spatial/block)``, c-major."""
    if block_size(block) == 1:
        return x
    n, c, *spatial = x.shape
    if any(s % b for s, b in zip(spatial, block)):
        raise ValueError(f"spatial {tuple(spatial)} not divisible by block {tuple(block)}")
    if _square2d(block):
        return F.pixel_unshuffle(x, block[0])
    d = len(block)
    shape = [n, c]
    for s, b in zip(spatial, block):
        shape += [s // b, b]
    # (n, c, g0, p0, g1, p1, ...) -> (n, c, p0, p1, ..., g0, g1, ...)
    perm = [0, 1] + [3 + 2 * i for i in range(d)] + [2 + 2 * i for i in range(d)]
    out = x.reshape(shape).permute(perm)
    return out.reshape(n, c * block_size(block), *(s // b for s, b in zip(spatial, block)))


def unpack(x: torch.Tensor, block: Block) -> torch.Tensor:
    """Inverse of :func:`pack`."""
    if block_size(block) == 1:
        return x
    if _square2d(block):
        return F.pixel_shuffle(x, block[0])
    n, cb, *grid = x.shape
    d = len(block)
    c = cb // block_size(block)
    perm = [0, 1]
    for i in range(d):  # (n, c, p0, ..., g0, ...) -> (n, c, g0, p0, g1, p1, ...)
        perm += [2 + d + i, 2 + i]
    out = x.reshape(n, c, *block, *grid).permute(perm)
    return out.reshape(n, c, *(g * b for g, b in zip(grid, block)))


def _phases(p: int, block: Block) -> list:
    """The per-dim offsets of phase ``p`` (row-major, dim 0 slowest)."""
    out = []
    for b in reversed(block):
        out.append(p % b)
        p //= b
    return out[::-1]


def _combine(per_dim, block_out: Block, block_in: Block, ksizes: Block) -> np.ndarray:
    """``M[kp..., p_out, p_in, k...]`` = the product over dims of the per-dim
    maps ``m[k, kp, out offset, in offset]``."""
    kprime = tuple(m.shape[1] for m in per_dim)
    out = np.zeros(kprime + (block_size(block_out), block_size(block_in)) + tuple(ksizes), np.float32)
    for pout in range(block_size(block_out)):
        iph = _phases(pout, block_out)
        for pin in range(block_size(block_in)):
            jph = _phases(pin, block_in)
            for kidx in np.ndindex(*ksizes):
                for kpidx in np.ndindex(*kprime):
                    if all(m[kidx[i], kpidx[i], iph[i], jph[i]] for i, m in enumerate(per_dim)):
                        out[kpidx + (pout, pin) + kidx] = 1.0
    return out


@lru_cache(maxsize=None)
def _conv_phase_map(block: Block, ksizes: Block) -> np.ndarray:
    """The constant 0/1 map of a k-SAME conv on the packed grid, shape
    ``(*kprime, B, B, *ksizes)``: ``K'[c_out·B + p_out, c_in·B + p_in, kp] =
    Σ_k W[c_out, c_in, k]·M[kp, p_out, p_in, k]``. Per dim with block b and
    kernel k (pad (k-1)//2), output offset i at tap d reads input offset
    ``s = i + d - pad = b·δ + j``: packed tap δ, input offset j. The JAX
    package's array (a correlation in both packages)."""
    per_dim = []
    for b, k in zip(block, ksizes):
        pad = (k - 1) // 2
        entries = [(dd, *divmod(i + dd - pad, b), i) for i in range(b) for dd in range(k)]
        dmin = min(e[1] for e in entries)
        dmax = max(e[1] for e in entries)
        m = np.zeros((k, dmax - dmin + 1, b, b), np.float32)
        for dd, delta, j, i in entries:
            m[dd, delta - dmin, i, j] = 1.0
        per_dim.append(m)
    return _combine(per_dim, block, block, ksizes)


@lru_cache(maxsize=None)
def _convt_phase_map(block_in: Block, block_out: Block) -> Tuple[np.ndarray, Block, Block]:
    """The map of the k=2 s=2 VALID transpose conv from ``block_in`` to
    ``block_out`` (per dim ``bo ∈ {bi, 2·bi}``): ``(M[kp..., p_out, p_in,
    k...], packed kernel sizes, packed strides)``.

    Derived for torch's weight as the port stores it (``conv_transpose``
    computes ``y[2q + i] += W[i]·x[q]``): the input at grid cell Q and offset
    j_in is dense position ``bi·Q + j_in``; its output ``2·bi·Q + v``, with
    ``v = 2·j_in + i``, is packed at grid cell ``s'·Q + ρ`` and offset
    ``j_out`` for ``(ρ, j_out) = divmod(v, bo)`` and the packed stride (and
    kernel) ``s' = 2·bi/bo``. So ``W'[slot ρ, j_out, j_in] = W[i]``. The
    JAX package's map is lax's convention, ``y[2q + i] = K[1 - i]·x[q]``, the
    same map with the tap and slot axes reversed."""
    per_dim = []
    for bi, bo in zip(block_in, block_out):
        if bo not in (bi, 2 * bi):
            raise ValueError(f"unsupported convT block pair {(bi, bo)}")
        sp = 2 * bi // bo
        m = np.zeros((2, sp, bo, bi), np.float32)  # (tap i, slot ρ, j_out, j_in)
        for jin in range(bi):
            for i in range(2):
                rho, jout = divmod(2 * jin + i, bo)
                m[i, rho, jout, jin] = 1.0
        per_dim.append(m)
    ksizes = tuple(m.shape[1] for m in per_dim)
    return _combine(per_dim, block_out, block_in, (2,) * len(block_in)), ksizes, ksizes


@lru_cache(maxsize=None)
def _gather_index(transposed: bool, block_in: Block, block_out: Block, ksizes: Block):
    """The phase map as a gather: for each ``(p_out, p_in, packed tap)`` the
    flat logical tap it copies, or ``Π ksizes`` (a zero slot) where none;
    with the packed kernel sizes and strides."""
    if transposed:
        m, kprime, strides = _convt_phase_map(block_in, block_out)
    else:
        m = _conv_phase_map(block_in, ksizes)
        kprime, strides = m.shape[:len(ksizes)], (1,) * len(ksizes)
    flat = m.reshape(math.prod(kprime), block_size(block_out), block_size(block_in), -1)
    if (flat.sum(-1) > 1).any():
        raise AssertionError("a packed tap sums several logical taps")
    idx = np.where(flat.any(-1), flat.argmax(-1), flat.shape[-1])
    return idx.transpose(1, 2, 0).copy(), tuple(kprime), tuple(strides)


@lru_cache(maxsize=256)
def _gather_tensor(transposed: bool, block_in: Block, block_out: Block, ksizes: Block, device):
    """:func:`_gather_index` on ``device``, built outside inference mode
    whatever the caller's (a served request first would otherwise cache an
    inference tensor, which a later train step cannot save for backward)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_gather_index(transposed, block_in, block_out, ksizes)[0]).to(device)


def _assemble(weight: torch.Tensor, block_in: Block, block_out: Block,
              transposed: bool = False) -> Tuple[torch.Tensor, Block, Block]:
    """The packed kernel from the logical ``weight`` (``(O, I, k...)``, or
    ``(I, O, k...)`` transposed): ``(O·B_out, I·B_in, kp...)`` (``(I·B_in,
    O·B_out, kp...)``), c-major; with the packed strides."""
    ksizes = tuple(weight.shape[2:])
    key = (transposed, tuple(block_in), tuple(block_out), ksizes)
    _, kprime, strides = _gather_index(*key)
    idx = trace_safe(_gather_tensor, *key, weight.device)
    a, b = weight.shape[:2]
    taps = F.pad(weight.reshape(a, b, -1), (0, 1))[:, :, idx]  # (a, b, Bo, Bi, KP)
    bo, bi = block_size(block_out), block_size(block_in)
    if transposed:  # (I, O, Bo, Bi, KP) -> (I, Bi, O, Bo, KP)
        return taps.permute(0, 3, 1, 2, 4).reshape(a * bi, b * bo, *kprime), kprime, strides
    return taps.permute(0, 2, 1, 3, 4).reshape(a * bo, b * bi, *kprime), kprime, strides


_CONV_FN = {2: F.conv2d, 3: F.conv3d}
_CONV_T_FN = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def packed_conv(x: torch.Tensor, weight: torch.Tensor, bias, block: Block,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The k-SAME conv of ``weight`` (``(O, I, k...)``, k odd) on ``x``
    packed with ``block`` (the same block out); the dense conv where the
    block is all ones."""
    d = weight.ndim - 2
    block = tuple(block) or (1,) * d
    if block_size(block) > 1:
        weight, kprime, _ = _assemble(weight, block, block)
        bias = None if bias is None else bias.repeat_interleave(block_size(block))
    else:
        kprime = tuple(weight.shape[2:])
    return conv_in_dtype(_CONV_FN[d], x, weight, bias, dtype, padding=tuple(k // 2 for k in kprime))


def packed_conv_transpose(x: torch.Tensor, weight: torch.Tensor, bias, block_in: Block,
                          block_out: Block, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The k=2 s=2 VALID transpose conv of ``weight`` (``(I, O, 2...)``) from
    ``x`` packed with ``block_in`` to the output packed with ``block_out``."""
    d = weight.ndim - 2
    block_in, block_out = tuple(block_in) or (1,) * d, tuple(block_out) or (1,) * d
    weight, _, strides = _assemble(weight, block_in, block_out, transposed=True)
    if bias is not None:
        bias = bias.repeat_interleave(block_size(block_out))
    return conv_in_dtype(_CONV_T_FN[d], x, weight, bias, dtype, stride=strides)


def packed_group_norm(x: torch.Tensor, logical_channels: int) -> torch.Tensor:
    """Instance norm (eps 1e-5, no affine) of the packed ``x``: one group
    per logical channel, its phase block; f32 statistics for reduced
    activations, the output in ``x``'s dtype. Instance norm itself where
    ``x`` is not packed."""
    if x.shape[1] == logical_channels:
        return instance_norm(x)
    if not is_reduced(x):
        return F.group_norm(x, logical_channels, eps=1e-5)
    return F.group_norm(x.float(), logical_channels, eps=1e-5).to(x.dtype)


def packed_avg_pool_2x(x: torch.Tensor, block_in: Block, block_out: Block) -> torch.Tensor:
    """The 2x average pool (floor semantics) of a tensor packed with
    ``block_in``, packed with ``block_out`` (per dim ``block_in`` or half
    of it, at least 1), the JAX package's three steps:

      * a dim with block b >= 2: dense ``s = b·g + p``, so a pooled pair
        shares g and ``p // 2``: the mean over ``p % 2``, in channel space;
      * a dim with block 1: crop the odd tail of the grid, mean adjacent
        cells (the only dims where the floor drops a row);
      * a dim whose block goes from ``mid = max(b // 2, 1)`` up to
        ``2·mid``: the pooled grid's parity becomes the slower part of its
        new offset, ``p' = mid·(g % 2) + p_mid``."""
    d = len(block_in)
    n, cb, *grid = x.shape
    c = cb // block_size(block_in)
    y = x.reshape(n, c, *block_in, *grid)  # offsets at axes 2.., grid at 2 + d..
    for i, b in enumerate(block_in):
        if b > 1:
            y = y.unflatten(2 + i, (b // 2, 2)).mean(3 + i)
    mid = tuple(max(b // 2, 1) for b in block_in)
    for i, b in enumerate(block_in):
        if b == 1:
            ax, g = 2 + d + i, y.shape[2 + d + i]
            y = y.narrow(ax, 0, g // 2 * 2).unflatten(ax, (g // 2, 2)).mean(ax + 1)
    raised = [i for i in range(d) if block_out[i] != mid[i]]
    for i in raised:
        if block_out[i] != 2 * mid[i]:
            raise ValueError(f"unsupported pool re-block {mid[i]} -> {block_out[i]} (dim {i})")
    if raised:
        shape, grid_axes, parity = [n, c, *mid], [], {}
        for i in range(d):
            g = y.shape[2 + d + i]
            grid_axes.append(len(shape))
            if i in raised:
                parity[i] = len(shape) + 1
                shape += [g // 2, 2]
            else:
                shape += [g]
        perm = [0, 1]
        for i in range(d):
            perm += ([parity[i]] if i in raised else []) + [2 + i]
        y = y.reshape(shape).permute(perm + grid_axes)
    return y.reshape(n, c * block_size(block_out), *y.shape[y.ndim - d:])


class PackedConv:
    """An ``nn.Conv2d`` / ``nn.Conv3d`` (k odd, SAME padding) run on the
    packed layout: ``forward(x, block, dtype)`` with ``x`` packed by
    ``block``, computed in ``dtype``; the dense module's parameters."""

    def forward(self, x: torch.Tensor, block: Block = (),
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return packed_conv(x, self.weight, self.bias, block, dtype)


class PackedConv2d(PackedConv, nn.Conv2d):
    pass


class PackedConv3d(PackedConv, nn.Conv3d):
    pass


class PackedConvTranspose:
    """An ``nn.ConvTranspose2d`` / ``3d`` (k=2, s=2) run from the packed
    layout: ``forward(x, block_in, block_out, dtype)``."""

    def forward(self, x: torch.Tensor, block_in: Block = (), block_out: Block = (),
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return packed_conv_transpose(x, self.weight, self.bias, block_in, block_out, dtype)


class PackedConvTranspose2d(PackedConvTranspose, nn.ConvTranspose2d):
    pass


class PackedConvTranspose3d(PackedConvTranspose, nn.ConvTranspose3d):
    pass


PACKED_CONV = {2: PackedConv2d, 3: PackedConv3d}
PACKED_CONV_T = {2: PackedConvTranspose2d, 3: PackedConvTranspose3d}
