"""Shared CLI plumbing of the three train/test entry points.

Counterpart of ``cinemri_tpu/cli/common.py`` for the VarNet, CineNet and
XPDNet families. Parity target: reference
traintest_scripts/{varnet,cinenet,xpdnet}/train_test_*.py — argument
surface, per-model defaults (SURVEY Appendix B), mode dispatch (train /
test with inference), checkpoint resume semantics. The parser keeps every
flag and default of the JAX package's, so a run's checkpoint directory
(named by :func:`config_fingerprint`) is the same in both packages;
``--device`` (default ``cuda``) picks the device, the counterpart of
``JAX_PLATFORMS``. Every dynamic type but CRNN runs; ``--packed`` left at
its default runs the dense conv stacks (the JAX package's packed layout is
numerically the same and not ported).

What is not ported raises ``NotImplementedError`` naming its ROADMAP item
(Queue 1): ``--dynamic_type CRNN`` (12); more than one device,
``--coil_devices``, ``--plane_devices``, more than one process and
``--coordinator_address`` (13); ``--mode export``, ``--from_torch_ckpt``,
``--bf16``, ``--packed 1`` and ``--profile_steps`` (14).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time
import warnings
from pathlib import Path
from typing import Dict

import torch

from cinemri_tpu_torch.data import (
    CineNetDataTransform,
    CombinedSliceDataset,
    PreprocessConfig,
    SliceDataset,
    VarNetDataTransform,
    XPDNetDataTransform,
    create_mask_for_mask_type,
)
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.train import Loader, Trainer, TrainerConfig
from cinemri_tpu_torch.utils.paths import fetch_dir

__all__ = ["build_parser", "train_test_main", "config_fingerprint"]

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
                        ".ckpt (not ported yet: ROADMAP Queue 1, item 14)")
    p.add_argument("--inference", default=1, choices=(0, 1), type=int)
    p.add_argument("--export_path", default=None, type=str,
                   help="output artifact path of --mode export (not ported yet: item 14)")
    p.add_argument("--serial_export", default=0, choices=(0, 1), type=int,
                   help="bake serve.serial_batch into the export artifact (item 14)")
    p.add_argument("--kernel_dc", default=1, choices=(0, 1), type=int,
                   help="precomputed-kernel data consistency (the normal-apply "
                        "kernel); 0 = the reference's direct k-space formulation")
    p.add_argument("--packed", default=None, choices=(0, 1), type=int,
                   help="space-to-depth lane packing of the conv stacks; the default "
                        "runs the dense stacks for every dynamic type (numerically the "
                        "same; 1 is not ported yet: item 14)")
    p.add_argument("--bf16", default=0, choices=(0, 1), type=int,
                   help="bfloat16 denoiser activations (not ported yet: item 14)")
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

    # parallelism (the reference's --accelerator dp/ddp + --gpus); one
    # device only until ROADMAP Queue 1, item 13
    p.add_argument("--num_devices", default=1, type=int,
                   help="Devices on the data-parallel axis; 0 = all visible; "
                        "more than 1 is not ported yet (item 13)")
    p.add_argument("--coil_devices", default=1, type=int,
                   help="Devices on the coil axis (not ported yet: item 13)")
    p.add_argument("--plane_devices", default=1, type=int,
                   help="Devices on the plane axis (not ported yet: item 13)")
    p.add_argument("--num_processes", default=1, type=int,
                   help="Multi-host process count (more than 1 is not ported yet: item 13)")
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of process 0 (not ported yet: item 13)")
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
                   help="Profile this many training steps (not ported yet: item 14)")
    p.add_argument("--profile_dir", default=None, type=Path,
                   help="Trace output dir (with --profile_steps)")
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


def _resolved_devices(args) -> int:
    """``--num_devices``, with 0 resolved to the devices visible to torch."""
    if args.num_devices > 0:
        return args.num_devices
    return max(1, torch.cuda.device_count()) if args.device.startswith("cuda") else 1


def _check_ported(args) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item (Queue 1) of
    the first option whose path the port does not have yet."""
    unported = [
        (args.dynamic_type == "CRNN", "--dynamic_type CRNN", "ROADMAP Queue 1, item 12: CRNN"),
        (_resolved_devices(args) > 1, f"--num_devices {args.num_devices}",
         "ROADMAP Queue 1, item 13: parallelism"),
        (args.coil_devices > 1, "--coil_devices", "ROADMAP Queue 1, item 13: parallelism"),
        (args.plane_devices > 1, "--plane_devices", "ROADMAP Queue 1, item 13: parallelism"),
        (args.num_processes > 1, "--num_processes", "ROADMAP Queue 1, item 13: parallelism"),
        (args.coordinator_address is not None, "--coordinator_address",
         "ROADMAP Queue 1, item 13: parallelism"),
        (args.mode == "export", "--mode export", "ROADMAP Queue 1, item 14: torch.export"),
        (args.from_torch_ckpt is not None, "--from_torch_ckpt",
         "ROADMAP Queue 1, item 14: interop/torch_import.py"),
        (bool(args.bf16), "--bf16", "ROADMAP Queue 1, item 14: bf16"),
        (bool(args.packed), "--packed 1", "ROADMAP Queue 1, item 14: packed_unet.py"),
        (args.profile_steps > 0, "--profile_steps", "ROADMAP Queue 1, item 14: instrument/"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet ({item})")


def _envelope_notices(family: str, args) -> None:
    """One-line runtime notices when a run leaves the certified parity
    envelope (PARITY.md "Parity envelope notes"): warnings, not errors.
    The JAX package's data-parallel lr notice comes back with data
    parallelism (ROADMAP Queue 1, item 13): until then ``_check_ported``
    refuses any run on more than one device; its bf16 notices come back
    with bf16 (item 14)."""
    if args.batch_size > 1:
        warnings.warn(
            f"batch_size={args.batch_size} (PER-DEVICE) is outside the "
            "certified parity envelope: the SSIM loss takes data_range "
            "per-sample here but per-batch in the reference (losses.py:34) "
            "— identical at batch_size=1, deliberately different above it",
            stacklevel=2,
        )
    if args.compress_coils:
        warnings.warn(
            f"--compress_coils {args.compress_coils} trades quality for "
            "coil-linear speed and is outside the parity envelope by "
            "construction (BASELINE.md 'SVD coil compression quality')",
            stacklevel=2,
        )
    if family == "xpdnet" and args.norm_buffers != -1 and bool(args.norm_buffers) != bool(args.bf16):
        warnings.warn(
            f"--norm_buffers {args.norm_buffers} overrides the certified pairing "
            "(normalization on exactly under --bf16): f32 with normalized buffers is a "
            "function change against the reference's raw-buffer semantics — intended "
            "only for evaluating a checkpoint trained with this setting",
            stacklevel=2,
        )


def _build_model_from_args(family: str, args):
    if family == "varnet":
        kwargs = dict(num_cascades=args.num_cascades, sens_chans=args.sens_chans,
                      sens_pools=args.sens_pools, chans=args.chans, pools=args.pools)
    elif family == "cinenet":
        kwargs = dict(num_cascades=args.num_cascades, cg_iters=args.CG_iters,
                      chans=args.chans, pools=args.pools)
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
    kwargs.update(weight_sharing=args.weight_sharing, kernel_dc=bool(args.kernel_dc))
    return build_model(family, args.dynamic_type, device=args.device, **kwargs)


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
    """The reference's train_test_main (train_test_varnet.py:22-136)."""
    args = build_parser(family).parse_args(argv)
    _check_ported(args)
    if args.load_model is None:
        args.load_model = 0
    _envelope_notices(family, args)
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
        device=args.device,
    )

    results: Dict = {"trainer": trainer}
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
    else:  # test
        trainer.init_state()
        if args.load_model:
            trainer.restore_latest()
        results["test_metrics"] = trainer.test()
        print("test metrics:", results["test_metrics"])

        if args.inference:
            from cinemri_tpu_torch.cli.inference import InferenceRunner

            inf_ds = SliceDataset(data_path / "inference", transform=transform,
                                  preprocess=preprocess, maps_cache_dir=args.maps_cache_dir)
            runner = InferenceRunner(model, None, family, save_path, device=args.device)
            total = 0.0
            print("Starting inference..............")
            for batch in Loader(inf_ds, batch_size=1).epoch(0):
                total += runner(batch)
            print(f"Elapsed time: {total} seconds.")
            results["inference_seconds"] = total
    return results
