"""Shared CLI plumbing of the three train/test entry points.

Counterpart of ``cinemri_tpu/cli/common.py`` for the VarNet, CineNet and
XPDNet families. Parity target: reference
traintest_scripts/{varnet,cinenet,xpdnet}/train_test_*.py — argument
surface, per-model defaults (SURVEY Appendix B), mode dispatch (train /
test with inference), checkpoint resume semantics. The parser keeps every
flag and default of the JAX package's, so a run's checkpoint directory
(named by :func:`config_fingerprint`) is the same in both packages;
``--device`` (default ``cuda``) picks the device, the counterpart of
``JAX_PLATFORMS``. Every dynamic type runs, CRNN included. ``--packed 1``
runs the conv stacks on the space-to-depth layout
(``models/denoisers/packed_unet.py``; the same function and parameters, so
checkpoints are shared and ``config_fingerprint`` leaves it out, as the JAX
CLI does); left at its default it runs the dense stacks for every dynamic
type, where the JAX CLI packs 2D, 3D and CRNN after its TPU measurement.

Parallel runs take one process per device, as the reference's DDP does:
``torchrun --nproc_per_node N -m cinemri_tpu_torch.cli.train_test_varnet
--num_devices 0 ...``, or N processes started with ``--num_processes N
--coordinator_address host:port --process_id i``. The mesh is the JAX
CLI's ``data x plane x coil``: ``--num_devices`` (the data-axis size; 0:
the processes // (coil x plane)) x ``--plane_devices`` x ``--coil_devices``
must equal the number of processes. Each process runs on
``cuda:LOCAL_RANK``, or the CPU with ``--device cpu`` (gloo in place of
NCCL), and loads its data shard of every global batch; on ``coil`` it keeps
its coils of it. ``--plane_devices`` splits the XT / XF plane batches (other
types raise the JAX CLI's ``ValueError``), ``--coil_devices`` the receive
coils. Unlike the JAX CLI, which forces its XLA normal backend on a coil
axis, the port keeps the normal-apply kernel there: each rank runs it on its
own coils and all-reduces.

``--from_torch_ckpt`` starts ``--mode train``, ``test`` or ``export`` from
a trained reference Lightning checkpoint (``interop.import_torch_checkpoint``).
``--mode export`` writes the weight-bound forward as a ``torch.export``
artifact (``serve.export_model``; ``<save_path>/<family>_<type>.pt2`` by
default), shaped like the first test batch, from the best checkpoint
(``--load_model`` defaults to 1 there), in one process. ``--profile_steps``
traces that many training steps into ``--profile_dir``
(``Trainer``; fold the trace with ``instrument.opstats``; the step's phases
and the model's sens net, regularizers and data consistency show as the
program spans of ``instrument.SPANS``).

``--bf16 1`` builds the model with bf16 denoiser activations (the JAX
package's ``bf16``; ``models/denoisers/activations.py``). The DFT and
normal-apply precision is ``CINEMRI_DFT_PRECISION`` (``ops.fft.
set_dft_precision``: ``highest``, ``high``, ``default``).

At start-up the CLI sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False, so f32 convolutions and
matmuls run in full f32 on the card, as every test and chip run of the port
does (torch's own default rounds convolution inputs to TF32), and prints the
setting; it also enables the compile cache (``utils/compile_cache.py``),
where the JAX CLI enables its. Library callers (``build_model``,
``Trainer``, ``bind_model``) set no global flag.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import math
import time
import warnings
from pathlib import Path
from typing import Dict

import torch
import torch.distributed as dist

from cinemri_tpu_torch.data import (
    CineNetDataTransform,
    CombinedSliceDataset,
    PreprocessConfig,
    SliceDataset,
    VarNetDataTransform,
    XPDNetDataTransform,
    create_mask_for_mask_type,
)
from cinemri_tpu_torch.models import build_model, check_plane_axis
from cinemri_tpu_torch.ops.fft import get_dft_precision
from cinemri_tpu_torch.parallel import (
    initialize,
    make_mesh,
    make_process_sum,
    mesh_coordinates,
    mesh_lead,
    process_info,
    set_mesh,
)
from cinemri_tpu_torch.parallel.distributed import local_device
from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig
from cinemri_tpu_torch.utils.compile_cache import enable_compile_cache
from cinemri_tpu_torch.utils.paths import fetch_dir

__all__ = ["build_parser", "train_test_main", "config_fingerprint", "full_f32"]

TRANSFORMS = {
    "varnet": VarNetDataTransform,
    "cinenet": CineNetDataTransform,
    "xpdnet": XPDNetDataTransform,
}

MODEL_DEFAULTS: Dict[str, Dict] = {
    # reference per-script set_defaults (train_test_varnet.py:249-262 etc.)
    "varnet": dict(num_cascades=10, pools=3, chans=16, sens_pools=3, sens_chans=8),
    "cinenet": dict(num_cascades=10, CG_iters=6, chans=16, pools=3),
    "xpdnet": dict(
        num_cascades=9,
        sens_chans=8,
        sens_pools=3,
        crnn_chans=18,
        n_scales=3,
        n_filters_per_scale=[16, 32, 64],
        n_convs_per_scale=[2, 2, 2],
        n_first_convs=1,
        first_conv_n_filters=16,
        res=False,
        primal_only=True,
        n_primal=5,
        n_dual=1,
    ),
}


def _family(family: str) -> str:
    if family not in MODEL_DEFAULTS:
        raise ValueError(f"unknown model family {family!r}")
    return family


def build_parser(family: str) -> argparse.ArgumentParser:
    """The JAX package's parser for ``family``, plus ``--device``."""
    family = _family(family)
    p = argparse.ArgumentParser(description=f"Train/test dynamic {family} on a GPU")

    # basic args (train_test_varnet.py:158-205)
    p.add_argument("--mode", default="train", choices=("train", "test", "export"))
    p.add_argument("--epochs", default=150, type=int)
    p.add_argument("--save_checkpoint", default=0, choices=(0, 1), type=int)
    p.add_argument("--resume_training", default=0, choices=(0, 1), type=int)
    # default resolves per mode: 0 for train/test (reference semantics,
    # train_test_varnet.py:59-67), 1 for export
    p.add_argument("--load_model", default=None, choices=(0, 1), type=int)
    p.add_argument("--from_torch_ckpt", default=None, type=Path,
                   help="initialize weights from a trained reference PyTorch/Lightning "
                        ".ckpt; combine with --mode test for drop-in evaluation, --mode "
                        "train to fine-tune or --mode export to serve it")
    p.add_argument("--inference", default=1, choices=(0, 1), type=int)
    p.add_argument("--export_path", default=None, type=str,
                   help="output artifact path (default save_path/<family>_<dynamic>.pt2)")
    p.add_argument("--serial_export", default=0, choices=(0, 1), type=int,
                   help="bake serve.serial_batch into the artifact (batch>1 serving)")
    p.add_argument("--kernel_dc", default=1, choices=(0, 1), type=int,
                   help="precomputed-kernel data consistency (the normal-apply "
                        "kernel); 0 = the reference's direct k-space formulation")
    p.add_argument("--packed", default=None, choices=(0, 1), type=int,
                   help="space-to-depth packing of the conv stacks (the same function and "
                        "parameters); the default runs the dense stacks for every dynamic type")
    p.add_argument("--bf16", default=0, choices=(0, 1), type=int,
                   help="bfloat16 denoiser activations (norm statistics, data consistency "
                        "and the kernels stay f32); trained quality is certified for the "
                        "dynamic types in cli.common.BF16_CERTIFIED")
    if family == "xpdnet":
        p.add_argument(
            "--norm_buffers", default=-1, choices=(-1, 0, 1), type=int,
            help="per-channel normalization of the MWCNN buffer inputs "
                 "(XPDNetBlock._apply_net); -1 = auto: on exactly under --bf16, "
                 "so off here. Forcing 0/1 selects a different trained function")

    # mask args (train_test_varnet.py:208-229)
    p.add_argument("--mask_type", default="random", choices=("random", "equispaced"))
    p.add_argument(
        "--use_seed", default=0, choices=(0, 1), type=int,
        help="Seed each sample's mask from its filename (deterministic "
             "across epochs/processes); the reference scripts pass False "
             "(train_test_varnet.py:34-36)",
    )
    p.add_argument(
        "--center_fractions", nargs="+", default=[10], type=float,
        help="Random mask: COUNT of central lines; equispaced: FRACTION",
    )
    p.add_argument("--accelerations", nargs="+", default=[4], type=int)

    # data args (data_module.py:252-315)
    p.add_argument("--path_config", default="dirs_path.yaml", type=Path)
    p.add_argument("--data_path", default=None, type=Path)
    p.add_argument("--test_path", default=None, type=Path)
    p.add_argument("--test_split", default="test", choices=("test", "challenge"))
    p.add_argument("--sample_rate", default=None, type=float)
    p.add_argument("--volume_sample_rate", default=None, type=float)
    p.add_argument(
        "--num_cols", nargs="+", default=None, type=int,
        help="Keep only volumes whose phase-encode width is in this list "
             "(the reference's mri_data.py:258-261 filter)",
    )
    p.add_argument(
        "--crop_shape", nargs=2, default=None, type=int, metavar=("NX", "NY"),
        help="Preprocess center-crop; reference hardcodes (200, 200) "
             "(mri_data.py:274). Auto-shrunk per volume when raw is smaller",
    )
    p.add_argument(
        "--crop_target", nargs=2, default=None, type=int, metavar=("NX", "NY"),
        help="Ground-truth target crop; reference hardcodes (180, 180)",
    )
    p.add_argument(
        "--n_slices", default=None, type=int,
        help="Temporal frames kept per volume; reference hardcodes 15",
    )
    _bool = lambda v: str(v).lower() in ("1", "true", "yes")
    p.add_argument("--use_dataset_cache_file", default=True, type=_bool)
    p.add_argument("--combine_train_val", default=False, type=_bool)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--maps_cache_dir", default=None, type=Path,
                   help="Cache dir for preprocessed volumes + ESPIRiT maps")
    p.add_argument("--ram_cache_volumes", default=8, type=int,
                   help="In-process LRU of decoded volumes (~100 MB each at "
                        "protocol size); 0 disables")
    p.add_argument(
        "--cache_sens_maps", default=0, choices=(0, 1), type=int,
        help="CineNet only: compute per-sample ESPIRiT maps once per volume "
             "instead of per epoch (reference recomputes each epoch)",
    )
    p.add_argument(
        "--compress_coils", default=0, type=int,
        help="SVD coil compression to this many virtual coils (0 = off, the "
             "reference behavior; data/compress.py)",
    )
    p.add_argument("--num_workers", default=4, type=int,
                   help="Decode-thread pool size of the host input pipeline; 0 "
                        "disables prefetch, 1 = serial decode in the prefetch thread")

    # parallelism (the reference's --accelerator ddp + --gpus): one process
    # per device, the batch sharded over a `data` mesh axis
    p.add_argument("--num_devices", default=1, type=int,
                   help="Devices on the data-parallel axis, one per process (torchrun "
                        "--nproc_per_node N, or --num_processes N); 0 = the processes // "
                        "(coil_devices x plane_devices). The per-device batch is --batch_size, "
                        "so the global batch is batch_size x num_devices (DDP semantics)")
    p.add_argument("--coil_devices", default=1, type=int,
                   help="Devices on the coil (tensor-parallel) axis: each holds its share of "
                        "the receive coils")
    p.add_argument("--plane_devices", default=1, type=int,
                   help="Devices on the plane (sequence-parallel) axis: each runs the plane "
                        "nets on its share of the XT/XF plane batches")
    p.add_argument("--num_processes", default=1, type=int,
                   help="Process count of a run started without torchrun (one device each)")
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of process 0's rendezvous (a free port), with --num_processes")
    p.add_argument("--process_id", default=0, type=int,
                   help="This process's index in [0, num_processes)")

    # model args (varnet_module.py:161-239 etc.)
    for k, v in MODEL_DEFAULTS[family].items():
        if isinstance(v, list):
            p.add_argument(f"--{k}", nargs="+", default=v, type=type(v[0]))
        elif isinstance(v, bool):
            p.add_argument(f"--{k}", default=v, type=lambda s: s in ("1", "true", "True"))
        else:
            p.add_argument(f"--{k}", default=v, type=type(v))
    p.add_argument("--dynamic_type", default="XF", choices=("XF", "XT", "2D", "3D", "CRNN"))
    p.add_argument("--weight_sharing", default=False,
                   type=lambda s: s in ("1", "true", "True"))

    # optimizer args (script defaults lr=1e-4, StepLR(140, 0.01))
    p.add_argument(
        "--torch_init", default=1, choices=(0, 1), type=int,
        help="Initialize weights with the reference torch reset_parameters "
             "statistics (default) instead of flax lecun_normal",
    )
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_step_size", default=140, type=int)
    p.add_argument("--lr_gamma", default=0.01, type=float)
    p.add_argument(
        "--clip_grad_norm", default=0.0, type=float,
        help="Global-norm gradient clip (0 = off, the reference recipe)",
    )
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--num_log_images", default=2, type=int)  # mri_module.py:505
    p.add_argument(
        "--compute_train_metrics", default=True, type=_bool,
        help="Per-step host-side train NMSE/SSIM (the reference's "
             "training_step_end behavior); disable for maximum step throughput",
    )
    p.add_argument(
        "--log_every_steps", default=1, type=int,
        help="Per-step TensorBoard cadence for training_loss/grad_norm; 0 = "
             "per-epoch only. With --compute_train_metrics 0 this also "
             "defers all loss syncs to epoch end",
    )
    p.add_argument("--profile_steps", default=0, type=int,
                   help="Trace this many training steps with torch.profiler (starting at "
                        "step 1; step 0 builds the kernels) into --profile_dir; fold with "
                        "cinemri_tpu_torch.instrument.opstats. 0 = off")
    p.add_argument("--profile_dir", default=None, type=Path,
                   help="Trace output dir (default: <log_dir>/tensorboard/profile)")
    p.add_argument(
        "--device_data_cache", default=1, choices=(0, 1), type=int,
        help="Keep per-sample constants (raw k-space, targets, stable sens "
             "maps) in device memory so each step sends only the mask "
             "(train/device_cache.py)",
    )
    p.add_argument("--device_data_cache_gb", default=4.0, type=float,
                   help="Device byte budget (GiB) of each of the train and evaluation "
                        "caches (LRU beyond it)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p


def _model_axes(args) -> Dict[str, int]:
    """The ``plane`` and ``coil`` dims of the run's mesh, those above 1."""
    sizes = {"plane": max(1, args.plane_devices), "coil": max(1, args.coil_devices)}
    return {k: v for k, v in sizes.items() if v > 1}


def _resolved_devices(args) -> int:
    """``--num_devices``, with 0 resolved to the processes (one device
    each) over the plane and coil dims, at least 1."""
    if args.num_devices > 0:
        return args.num_devices
    return max(1, process_info()[1] // math.prod(_model_axes(args).values()))


def full_f32() -> None:
    """Run f32 convolutions and matmuls in full f32 on the card (torch's
    default rounds convolution inputs to TF32), and print the setting with
    the DFT precision. The CLI's start-up; library code sets no global flag."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("float32 convolutions and matmuls in full float32 (torch.backends.cudnn.allow_tf32 = "
          "False, torch.backends.cuda.matmul.allow_tf32 = False); DFT and normal-apply "
          f"precision {get_dft_precision()!r}")


# (family, dynamic_type) pairs whose bf16 TRAINED quality carries a measured
# head-to-head ΔSSIM row in the JAX package (BASELINE.md "Trained parity" bf16
# sections); other combinations run, with no quality row
BF16_CERTIFIED = {
    ("varnet", "XF"), ("varnet", "CRNN"), ("cinenet", "XF"), ("xpdnet", "XF"),
}


def _envelope_notices(family: str, args, n_devices: int | None = None) -> None:
    """One-line runtime notices when a run leaves the certified parity
    envelope (PARITY.md "Parity envelope notes"): warnings, not errors.
    ``n_devices`` is the data-parallel size (default: the resolved
    ``--num_devices``)."""
    n = _resolved_devices(args) if n_devices is None else n_devices
    if args.profile_steps and args.mode != "train":
        warnings.warn(
            "--profile_steps only traces training steps (Trainer.fit); it "
            f"has no effect in --mode {args.mode}",
            stacklevel=2,
        )
    if args.batch_size > 1:
        warnings.warn(
            f"batch_size={args.batch_size} (PER-DEVICE) is outside the "
            "certified parity envelope: the SSIM loss takes data_range "
            "per-sample here but per-batch in the reference (losses.py:34) "
            "— identical at batch_size=1, deliberately different above it",
            stacklevel=2,
        )
    if args.mode == "train" and n != 1 and args.batch_size == 1 and abs(args.lr - 1e-4) < 1e-12:
        warnings.warn(
            f"--num_devices {n} at the default --lr 1e-4: "
            "the certified data-parallel recipe scales lr LINEARLY with "
            "the global batch (--lr {:.0e} here); unscaled lr measured "
            "ΔSSIM −0.23 vs the b=1 schedule at the 30-epoch screen "
            "(BASELINE.md 'Data-parallel trained quality at global "
            "batch 8')".format(1e-4 * n),
            stacklevel=2,
        )
    if args.bf16 and (family, args.dynamic_type) not in BF16_CERTIFIED and args.mode == "train":
        certified = ", ".join(f"{f}-{d}" for f, d in sorted(BF16_CERTIFIED) if f == family)
        warnings.warn(
            f"--bf16 with --dynamic_type {args.dynamic_type}: trained "
            f"quality for this {family} variant has no head-to-head ΔSSIM "
            f"row (certified: {certified}); inference throughput was "
            "measured, training works, but the <0.001 parity claim does "
            "not extend to it (BASELINE.md 'Trained parity')",
            stacklevel=2,
        )
    if args.compress_coils:
        warnings.warn(
            f"--compress_coils {args.compress_coils} trades quality for "
            "coil-linear speed and is outside the parity envelope by "
            "construction (BASELINE.md 'SVD coil compression quality')",
            stacklevel=2,
        )
    if family == "xpdnet" and args.norm_buffers != -1 and args.dynamic_type == "CRNN":
        warnings.warn(
            "--norm_buffers has no effect for --dynamic_type CRNN: XPDNetRNN's BCRNN "
            "correction does not route buffers through MWCNN, so there is nothing to "
            "normalize — the flag is ignored",
            stacklevel=2,
        )
    if (family == "xpdnet" and args.norm_buffers != -1 and args.dynamic_type != "CRNN"
            and bool(args.norm_buffers) != bool(args.bf16)):
        warnings.warn(
            f"--norm_buffers {args.norm_buffers} overrides the certified "
            f"pairing (normalization on exactly under --bf16): bf16 on raw "
            "buffers deviates beyond the parity budget, and f32+norm is a "
            "function change vs the reference's raw-buffer semantics "
            "(xpdnet.py:474-489) — intended only for evaluating a "
            "checkpoint trained with this setting (BASELINE.md 'bf16 "
            "activation mode')",
            stacklevel=2,
        )


def _build_model_from_args(family: str, args):
    crnn = args.dynamic_type == "CRNN"
    if family == "varnet":
        kwargs = dict(num_cascades=args.num_cascades, sens_chans=args.sens_chans,
                      sens_pools=args.sens_pools, chans=args.chans)
    elif family == "cinenet":
        kwargs = dict(num_cascades=args.num_cascades, cg_iters=args.CG_iters, chans=args.chans)
    elif crnn:  # xpdnet
        kwargs = dict(num_cascades=args.num_cascades, sens_chans=args.sens_chans,
                      sens_pools=args.sens_pools, chans=args.crnn_chans,
                      primal_only=args.primal_only, n_primal=args.n_primal, n_dual=args.n_dual)
    else:  # xpdnet
        kwargs = dict(num_cascades=args.num_cascades, sens_chans=args.sens_chans,
                      sens_pools=args.sens_pools, n_scales=args.n_scales,
                      n_filters_per_scale=tuple(args.n_filters_per_scale),
                      n_convs_per_scale=tuple(args.n_convs_per_scale),
                      n_first_convs=args.n_first_convs,
                      first_conv_n_filters=args.first_conv_n_filters, res=args.res,
                      primal_only=args.primal_only, n_primal=args.n_primal,
                      n_dual=args.n_dual,
                      norm_buffers=None if args.norm_buffers == -1 else bool(args.norm_buffers))
    if not crnn:  # the CRNN models have no pools and no weight sharing
        kwargs.update(weight_sharing=args.weight_sharing)
        if family != "xpdnet":
            kwargs.update(pools=args.pools)
    kwargs.update(kernel_dc=bool(args.kernel_dc), bf16=bool(args.bf16), packed=bool(args.packed))
    kwargs.update({f"{axis}_axis": axis for axis in _model_axes(args)})
    return build_model(family, args.dynamic_type, device=args.device, **kwargs)


def _apply_torch_ckpt(trainer, family: str, args) -> None:
    """--from_torch_ckpt: replace the trainer's initialized weights with a
    trained reference checkpoint's (``interop.import_torch_checkpoint``)."""
    from cinemri_tpu_torch.interop import check_tree_matches, import_torch_checkpoint

    state_dict, kwargs, fam, dyn = import_torch_checkpoint(args.from_torch_ckpt, family=family)
    if kwargs or dyn == "CRNN":
        # the checkpoint knows its own architecture (hparams / CRNN trunk)
        if dyn != args.dynamic_type:
            raise ValueError(f"checkpoint is a {fam}-{dyn} model but --dynamic_type is "
                             f"{args.dynamic_type}")
    elif args.dynamic_type != "XF" or args.weight_sharing:
        # a bare state dict without hparams: trust the CLI's architecture flags
        state_dict, *_ = import_torch_checkpoint(
            args.from_torch_ckpt, family=family, dynamic_type=args.dynamic_type,
            weight_sharing=bool(args.weight_sharing))
    if trainer.state is None:
        trainer.init_state()
    check_tree_matches(state_dict, trainer.state.model)
    trainer.state.model.load_state_dict(state_dict)
    print(f"Initialized weights from reference checkpoint {args.from_torch_ckpt}")


def config_fingerprint(family: str, args) -> str:
    """Short hash of every model-tree-defining argument, the JAX package's
    recipe: the same string for the same argv. Scopes the checkpoint
    directory and is stored inside each checkpoint."""
    # compress_coils changes the semantics of trained weights (virtual vs
    # physical coil inputs), not the tree shape — still scope by it
    keys = sorted(MODEL_DEFAULTS[family]) + ["dynamic_type", "weight_sharing", "compress_coils"]
    src = [(k, getattr(args, k)) for k in keys]
    if family == "xpdnet" and args.dynamic_type != "CRNN":
        # norm_buffers selects another trained function on the same tree;
        # appended only when on, as the JAX package does
        if bool(args.bf16) if args.norm_buffers == -1 else bool(args.norm_buffers):
            src.append(("norm_buffers", True))
    return hashlib.sha1(repr(src).encode()).hexdigest()[:8]


def train_test_main(family: str, argv=None) -> Dict:
    """The reference's train_test_main (train_test_varnet.py:22-136); one
    process of a data-parallel run when started as one (module docstring)."""
    full_f32()
    enable_compile_cache()
    args = build_parser(family).parse_args(argv)
    check_plane_axis(args.dynamic_type, args.plane_devices > 1)  # before the process group
    if args.from_torch_ckpt and args.resume_training:
        raise ValueError("--from_torch_ckpt and --resume_training are mutually exclusive")
    if args.profile_steps < 0:
        raise ValueError(f"--profile_steps counts the steps to trace, got {args.profile_steps}")
    if args.mode == "export" and (args.num_devices != 1 or args.num_processes > 1
                                  or _model_axes(args)):
        raise ValueError("--mode export runs in one process: the artifact holds the "
                         "single-device forward")
    if args.load_model is None:
        args.load_model = 1 if args.mode == "export" else 0
    elif args.mode == "export" and not args.load_model:
        warnings.warn(
            "--mode export with --load_model 0 exports RANDOMLY INITIALIZED "
            "weights — only useful for artifact-format testing",
            stacklevel=1,
        )
    # the process group first: the device and the data-parallel size depend on it
    started = not dist.is_initialized()
    rank, world = initialize(args.coordinator_address, args.num_processes, args.process_id,
                             device=args.device)
    try:
        return _train_test(family, args, rank, world)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train_test(family: str, args, rank: int, world: int) -> Dict:
    args.device = str(local_device(args.device, rank))
    n_devices = _resolved_devices(args)
    axes = _model_axes(args)
    total = n_devices * math.prod(axes.values())
    if total != world:
        mesh_args = "".join(f" --{k}_devices {v}" for k, v in axes.items())
        if world == 1:
            raise ValueError(
                f"--num_devices {n_devices}{mesh_args} runs one process per device: launch "
                f"{total} processes with `torchrun --nproc_per_node {total} -m <this module> "
                f"--num_devices {n_devices}{mesh_args} ...`, or start each with "
                f"`--num_processes {total} --coordinator_address host:port --process_id i`")
        raise ValueError(f"--num_devices {args.num_devices}{mesh_args} needs {total} processes "
                         f"(one device each), this run has {world}; or pass --num_devices 0")
    _envelope_notices(family, args, n_devices)
    mesh = make_mesh({"data": n_devices, **axes}) if world > 1 else None
    coords = mesh_coordinates(mesh) if mesh is not None else {"data": 0}
    with set_mesh(mesh):
        return _run(family, args, mesh, n_devices, coords)


def _run(family: str, args, mesh, n_devices: int, coords: Dict[str, int]) -> Dict:
    """The run itself, under the ambient mesh; ``coords`` is this rank's
    index on each mesh dim."""
    data_path = args.data_path or fetch_dir("data_path", args.path_config)
    save_path = fetch_dir("save_path", args.path_config)
    log_root = fetch_dir("log_path", args.path_config) / family / f"{family}_logs"
    # scope checkpoints per (dynamic_type, acceleration, model-config hash),
    # mirroring the reference's stamped filename (train_test_varnet.py:270-277)
    fingerprint = config_fingerprint(family, args)
    ckpt_dir = (
        log_root / "checkpoints"
        / f"{family}_{args.dynamic_type}_acc{args.accelerations[0]}_{fingerprint}"
    )

    mask_func = create_mask_for_mask_type(args.mask_type, args.center_fractions, args.accelerations)
    transform_kwargs = dict(mask_func=mask_func, use_seed=bool(args.use_seed),
                            compress_coils=args.compress_coils)
    if family == "cinenet":
        transform_kwargs.update(cache_maps=bool(args.cache_sens_maps),
                                maps_cache_dir=args.maps_cache_dir)
    transform = TRANSFORMS[family](**transform_kwargs)

    preprocess = PreprocessConfig()
    if args.crop_shape:
        preprocess = dataclasses.replace(preprocess, crop_shape=tuple(args.crop_shape))
    if args.crop_target:
        preprocess = dataclasses.replace(preprocess, crop_target=tuple(args.crop_target))
    if args.n_slices:
        preprocess = dataclasses.replace(preprocess, n_slices=args.n_slices)

    def make_loader(split, shuffle):
        is_train = split == "train"
        common = dict(use_dataset_cache=args.use_dataset_cache_file,
                      dataset_cache_file=log_root / "dataset_cache.pkl", num_cols=args.num_cols,
                      preprocess=preprocess, maps_cache_dir=args.maps_cache_dir,
                      ram_cache_volumes=args.ram_cache_volumes)
        if is_train and args.combine_train_val:
            # merge train+valid for training (data_module.py:156-176)
            ds = CombinedSliceDataset(
                roots=[data_path / "train", data_path / "valid"],
                transforms=[transform, transform],
                sample_rates=[args.sample_rate] * 2 if args.sample_rate is not None else None,
                volume_sample_rates=(
                    [args.volume_sample_rate] * 2 if args.volume_sample_rate is not None else None
                ),
                **common,
            )
        else:
            root = (args.test_path if (split == args.test_split and args.test_path)
                    else data_path / split)
            ds = SliceDataset(
                root,
                transform=transform,
                sample_rate=args.sample_rate if is_train else None,
                volume_sample_rate=args.volume_sample_rate if is_train else None,
                **common,
            )
        return Loader(
            ds,
            batch_size=args.batch_size,
            shuffle=shuffle,
            seed=args.seed,
            prefetch_size=2 if args.num_workers > 0 else 0,
            num_workers=max(int(args.num_workers), 1),
            # each data group feeds its shard of the example list; eval
            # shards volume-aware so whole volumes stay on one data group
            # (the reference's VolumeSampler, data_module.py:189-194)
            num_replicas=n_devices,
            rank=coords["data"],
            volume_aware=not is_train,
        )

    model = _build_model_from_args(family, args)
    cfg = TrainerConfig(
        epochs=args.epochs,
        lr=args.lr,
        lr_step_size=args.lr_step_size,
        lr_gamma=args.lr_gamma,
        clip_grad_norm=args.clip_grad_norm,
        weight_decay=args.weight_decay,
        seed=args.seed,
        ckpt_dir=ckpt_dir,
        log_dir=log_root / "tensorboard",
        save_path=save_path,
        num_log_images=args.num_log_images,
        compute_train_metrics=args.compute_train_metrics,
        torch_init=bool(args.torch_init),
        config_fingerprint=fingerprint,
        profile_steps=args.profile_steps,
        profile_dir=args.profile_dir,
        log_every_steps=args.log_every_steps,
        device_data_cache=bool(args.device_data_cache),
        device_data_cache_gb=args.device_data_cache_gb,
    )
    trainer = Trainer(
        model,
        cfg,
        train_loader=make_loader("train", shuffle=True),
        val_loader=make_loader("valid", shuffle=False),
        test_loader=make_loader(args.test_split, shuffle=False),
        mesh=mesh,
        reduce_fn=make_process_sum(mesh),
        device=args.device,
    )

    results: Dict = {"trainer": trainer}
    if args.mode == "train" and args.from_torch_ckpt:
        _apply_torch_ckpt(trainer, family, args)
    if args.mode == "train":
        print(
            f"Training {family} {args.dynamic_type} with {args.num_cascades} "
            f"cascades for {args.epochs} epochs.\nData is subsampled with a "
            f"{args.mask_type} mask, acceleration {args.accelerations[0]}."
        )
        t0 = time.perf_counter()
        results["history"] = trainer.fit(resume=bool(args.resume_training))
        print(f"Training time: {(time.perf_counter() - t0) / 3600.} hours")
        if args.save_checkpoint:
            trainer.ckpt.save(args.epochs, trainer._ckpt_tree(args.epochs))
    elif args.mode == "export":
        from cinemri_tpu_torch.ops.cplx import from_complex
        from cinemri_tpu_torch.serve import export_model

        trainer.init_state()
        if args.from_torch_ckpt:
            _apply_torch_ckpt(trainer, family, args)
        elif args.load_model:
            trainer.restore_best()  # serve the best-val weights
        first = trainer.test_loader.first_batch()
        sens = from_complex(first["sens_maps"]) if family == "cinenet" else None
        out_path = Path(args.export_path or save_path / f"{family}_{args.dynamic_type}.pt2")
        out_path.parent.mkdir(parents=True, exist_ok=True)
        export_model(model, None, from_complex(first["masked_kspace"]),
                     torch.as_tensor(first["mask"], dtype=torch.float32), path=out_path,
                     sens_maps=sens, serial=bool(args.serial_export))
        print(f"Exported serving artifact to {out_path}")
        results["export_path"] = str(out_path)
    else:  # test
        trainer.init_state()
        if args.from_torch_ckpt:
            _apply_torch_ckpt(trainer, family, args)
        elif args.load_model:
            trainer.restore_latest()
        results["test_metrics"] = trainer.test()
        print("test metrics:", results["test_metrics"])

        # the first data group runs the inference (its plane and coil ranks
        # together) and its rank 0 alone writes the files
        if args.inference and coords["data"] == 0:
            from cinemri_tpu_torch.cli.inference import InferenceRunner

            inf_ds = SliceDataset(data_path / "inference", transform=transform,
                                  preprocess=preprocess, maps_cache_dir=args.maps_cache_dir)
            runner = InferenceRunner(model, None, family, save_path, device=args.device,
                                     write=mesh_lead(mesh))
            total = 0.0
            print("Starting inference..............")
            for batch in Loader(inf_ds, batch_size=1).epoch(0):
                total += runner(batch)
            print(f"Elapsed time: {total} seconds.")
            results["inference_seconds"] = total
    return results
