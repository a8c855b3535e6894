"""The port's VarNet CLI (cinemri_tpu_torch.cli) against the JAX package's on
the CPU: the parser, the config fingerprint, the artifact names of the
train -> test (with inference) -> visualize flow, the inference helpers,
the options whose path is not ported yet, and a CRNN run of each family.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cinemri_tpu.cli import common as JC
from cinemri_tpu.cli import inference as JI
from cinemri_tpu.cli import visualize as JV

from cinemri_tpu_torch.cli import common as TC
from cinemri_tpu_torch.cli import inference as TI
from cinemri_tpu_torch.cli import visualize as TV
from cinemri_tpu_torch.data.synthetic import make_synthetic_dataset
from cinemri_tpu_torch.utils.paths import DEFAULT_CONFIG, fetch_dir

torch.set_num_threads(2)

TINY = ["--num_cascades", "1", "--chans", "4", "--pools", "2", "--sens_chans", "4",
        "--sens_pools", "2", "--center_fractions", "6", "--accelerations", "2"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The JAX CLI test's tree: one 4-frame, 3-coil, 32x32 volume per split."""
    root = tmp_path_factory.mktemp("torchcli")
    make_synthetic_dataset(root / "data", splits=("train", "valid", "test", "inference"),
                           volumes_per_split=1, num_frames=4, num_coils=3, h=32, w=32)
    with open(root / "dirs_path.yaml", "w") as f:
        yaml.dump({"data_path": str(root / "data"), "log_path": str(root / "logs"),
                   "save_path": str(root / "results")}, f)
    return root


class TestParser:
    def test_defaults_match_jax(self):
        """Every flag of the JAX parser is kept, with its default; the port
        adds --device (cuda)."""
        want = vars(JC.build_parser("varnet").parse_args([]))
        got = vars(TC.build_parser("varnet").parse_args([]))
        assert set(got) - set(want) == {"device"}
        assert {k: got[k] for k in want} == want
        assert got["device"] == "cuda"

    @pytest.mark.parametrize("argv", [
        [], TINY, ["--dynamic_type", "XT"], ["--compress_coils", "6"],
        ["--weight_sharing", "1", "--chans", "8"], ["--bf16", "1", "--lr", "3e-4"],
    ])
    def test_config_fingerprint_matches_jax(self, argv):
        """The same argv names the same checkpoint directory in both packages."""
        want = JC.config_fingerprint("varnet", JC.build_parser("varnet").parse_args(argv))
        got = TC.config_fingerprint("varnet", TC.build_parser("varnet").parse_args(argv))
        assert got == want and len(got) == 8

    def test_num_devices_0_resolves_and_skips_the_lr_notice(self):
        """--num_devices 0 counts the visible devices (one CPU device here):
        the run is not refused as parallel and gets no notice."""
        args = TC.build_parser("varnet").parse_args(["--num_devices", "0", "--device", "cpu"])
        assert TC._resolved_devices(args) == 1
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            TC._envelope_notices("varnet", args)
        assert not caught


# (family, argv, error, message): the options not ported yet name their
# ROADMAP item; the parallel launch flags and mesh axes (items 13 and 13b),
# ported, refuse a launch that cannot run: a mesh of 2 at one process, and
# the plane axis of a type without plane batches (the JAX CLI's message)
_OPTION_CASES = [
    ("varnet", ["--num_devices", "2"], ValueError, "torchrun --nproc_per_node 2"),
    ("varnet", ["--coil_devices", "2"], ValueError, "torchrun --nproc_per_node 2"),
    ("varnet", ["--plane_devices", "2", "--dynamic_type", "2D"], ValueError,
     "--plane_devices shards the XT/XF rotated-plane batches; dynamic_type '2D' has none"),
    ("varnet", ["--num_processes", "2"], ValueError, "--coordinator_address host:port"),
    ("varnet", ["--coordinator_address", "localhost:1234", "--process_id", "1"], ValueError,
     r"--process_id 1 is not in \[0, 1\)"),
    ("varnet", ["--mode", "export"], NotImplementedError, "item 14"),
    ("varnet", ["--from_torch_ckpt", "model.ckpt"], NotImplementedError, "item 14"),
    ("varnet", ["--bf16", "1"], NotImplementedError, "item 14"),
    ("varnet", ["--packed", "1"], NotImplementedError, "item 14"),
    ("varnet", ["--profile_steps", "2"], NotImplementedError, "item 14"),
    ("cinenet", ["--bf16", "1"], NotImplementedError, "item 14"),
    ("xpdnet", ["--packed", "1", "--dynamic_type", "2D"], NotImplementedError, "item 14"),
]


@pytest.mark.parametrize("family, argv, error, match", _OPTION_CASES, ids=[
    f"{case[0]}-argv{i}-item {13 if i < 5 else 14}" for i, case in enumerate(_OPTION_CASES)])
def test_unported_options_raise_naming_their_item(family, argv, error, match, monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)  # --num_processes without an address
    with pytest.raises(error, match=match):
        TC.train_test_main(family, argv + ["--device", "cpu"])


def test_fetch_dir_reads_and_writes_template(tmp_path):
    cfg = tmp_path / "dirs.yaml"
    with pytest.warns(UserWarning, match="template"):
        assert str(fetch_dir("save_path", cfg)) == DEFAULT_CONFIG["save_path"]
    assert yaml.safe_load(cfg.read_text()) == DEFAULT_CONFIG
    cfg.write_text(yaml.dump({"save_path": "/x/y"}))
    assert str(fetch_dir("save_path", cfg)) == "/x/y"


class TestInferenceHelpers:
    def test_zero_filled_recon_matches_jax(self, rng):
        k = (rng.standard_normal((1, 4, 3, 16, 12)) + 1j * rng.standard_normal((1, 4, 3, 16, 12)))
        np.testing.assert_array_equal(TI.zero_filled_recon(k), JI.zero_filled_recon(k))

    @pytest.mark.parametrize("t, static_mask", [(37, False), (37, True), (10, False)])
    def test_long_clip_matches_jax(self, rng, t, static_mask):
        """Chunks of 15 frames, the last left-extended: a linear 'model'
        reproduces the unchunked result, as in the JAX package."""
        k = rng.standard_normal((1, t, 2, 8, 8)).astype(np.complex64)
        mask = np.ones((1, 1 if static_mask else t, 1, 8, 1), np.float32)
        forward = lambda kc, mc: np.abs(kc).sum(axis=2) * mc[:, :, 0, :, :]
        got = TI.reconstruct_long_clip(forward, k, mask)
        np.testing.assert_array_equal(got, JI.reconstruct_long_clip(forward, k, mask))
        np.testing.assert_allclose(got, forward(k, mask), rtol=1e-6)


def test_cli_flow_leaves_the_jax_flow_artifact_names(workdir, tmp_path):
    """train (2 epochs, final checkpoint) -> test --load_model 1 --inference 1
    -> visualize, all with --device cpu. The checkpoint directory is named
    as the JAX flow names it (its fingerprint), and the results hold the
    names the JAX package's InferenceRunner and visualize write for the
    same batch (run on a stand-in model) plus SSIMs.csv."""
    common = TINY + ["--path_config", str(workdir / "dirs_path.yaml"),
                     "--maps_cache_dir", str(workdir / "maps"), "--device", "cpu"]
    out = TC.train_test_main("varnet", common + ["--mode", "train", "--epochs", "2",
                                                 "--save_checkpoint", "1"])
    assert len(out["history"]) == 2 and np.isfinite(out["history"][-1]["train_loss"])
    fp = JC.config_fingerprint("varnet", JC.build_parser("varnet").parse_args(TINY))
    ckpt = workdir / "logs" / "varnet" / "varnet_logs" / "checkpoints" / f"varnet_XF_acc2_{fp}"
    assert sorted(p.name for p in ckpt.iterdir()) == ["0.pt", "1.pt", "2.pt", "best_steps.json"]

    out = TC.train_test_main("varnet", common + ["--mode", "test", "--load_model", "1",
                                                 "--inference", "1"])
    m = out["test_metrics"]
    assert set(m) >= {"nmse", "ssim", "psnr", "loss"} and 0 < m["ssim"] <= 1
    assert out["inference_seconds"] > 0
    results = workdir / "results"
    assert len(TV.main(["--save_path", str(results)])) == 1
    got = sorted(str(p.relative_to(results)) for p in results.rglob("*") if p.is_file())

    # the JAX package's names for the same inference batch
    trainer = out["trainer"]
    from cinemri_tpu_torch.data import SliceDataset
    from cinemri_tpu_torch.train import Loader

    inf = SliceDataset(workdir / "data" / "inference", transform=trainer.test_loader.dataset.transform,
                       maps_cache_dir=workdir / "maps")
    batch = Loader(inf, batch_size=1).first_batch()

    class StandIn:  # returns the target's shape; only the names matter here
        def apply(self, params, k, mask):
            return jnp.zeros(k.re.shape[:2] + k.re.shape[-2:], jnp.float32)

    jroot = tmp_path / "jax_results"
    JI.InferenceRunner(StandIn(), {}, "varnet", jroot)(batch)
    JV.main(["--save_path", str(jroot)])
    want = sorted(str(p.relative_to(jroot)) for p in jroot.rglob("*") if p.is_file())
    assert got == sorted(want + ["SSIMs.csv"])
    assert len((results / "SSIMs.csv").read_text().splitlines()) == 1  # one test volume


FAMILY_TINY = {
    "cinenet": ["--num_cascades", "1", "--chans", "4", "--pools", "2", "--CG_iters", "2",
                "--dynamic_type", "2D"],
    "xpdnet": ["--num_cascades", "1", "--sens_chans", "4", "--sens_pools", "2", "--n_scales", "2",
               "--first_conv_n_filters", "4", "--n_filters_per_scale", "4", "8", "--n_primal", "2"],
}


@pytest.mark.parametrize("family", ["cinenet", "xpdnet"])
def test_family_parser_and_fingerprint_match_jax(family):
    """Every flag of the JAX parser with its default (the port adds
    --device), and the same checkpoint fingerprint for the same argv,
    norm_buffers included."""
    want = vars(JC.build_parser(family).parse_args([]))
    got = vars(TC.build_parser(family).parse_args([]))
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    argvs = [[], FAMILY_TINY[family], ["--dynamic_type", "3D" if family == "cinenet" else "2D"]]
    if family == "xpdnet":
        argvs += [["--norm_buffers", "1"], ["--norm_buffers", "0"], ["--primal_only", "0"]]
    for argv in argvs:
        fp = JC.config_fingerprint(family, JC.build_parser(family).parse_args(argv))
        assert TC.config_fingerprint(family, TC.build_parser(family).parse_args(argv)) == fp


@pytest.mark.parametrize("family", ["cinenet", "xpdnet"])
def test_family_cli_flow_leaves_the_jax_flow_artifact_names(family, workdir, tmp_path):
    """train (1 epoch, final checkpoint) -> test --load_model 1 --inference 1
    with --device cpu: the checkpoint directory the JAX flow names and the
    inference artifacts the JAX package's InferenceRunner writes for the
    same batch (run on a stand-in model)."""
    common = FAMILY_TINY[family] + [
        "--center_fractions", "6", "--accelerations", "2", "--path_config",
        str(workdir / "dirs_path.yaml"), "--maps_cache_dir", str(workdir / "maps"),
        "--device", "cpu"]
    out = TC.train_test_main(family, common + ["--mode", "train", "--epochs", "1",
                                               "--save_checkpoint", "1"])
    assert np.isfinite(out["history"][-1]["train_loss"])
    fp = JC.config_fingerprint(family, JC.build_parser(family).parse_args(common[:-6]))
    dyn = "2D" if family == "cinenet" else "XF"
    ckpt = workdir / "logs" / family / f"{family}_logs" / "checkpoints" / f"{family}_{dyn}_acc2_{fp}"
    assert sorted(p.name for p in ckpt.iterdir()) == ["0.pt", "1.pt", "best_steps.json"]

    out = TC.train_test_main(family, common + ["--mode", "test", "--load_model", "1",
                                               "--inference", "1"])
    assert 0 < out["test_metrics"]["ssim"] <= 1 and out["inference_seconds"] > 0
    results = workdir / "results"
    got = {str(p.relative_to(results)) for p in results.rglob("*.npy")}

    trainer = out["trainer"]
    from cinemri_tpu_torch.data import SliceDataset
    from cinemri_tpu_torch.train import Loader

    inf = SliceDataset(workdir / "data" / "inference", transform=trainer.test_loader.dataset.transform,
                       maps_cache_dir=workdir / "maps")
    batch = Loader(inf, batch_size=1).first_batch()

    class StandIn:  # returns the target's shape; only the names matter here
        def apply(self, params, k, mask, *maps):
            return jnp.zeros(k.re.shape[:2] + k.re.shape[-2:], jnp.float32)

    jroot = tmp_path / "jax_results"
    JI.InferenceRunner(StandIn(), {}, family, jroot)(batch)
    want = {str(p.relative_to(jroot)) for p in jroot.rglob("*") if p.is_file()}
    assert len(want) == 3 and want <= got  # target, output_<family>, zero_filled


CRNN_TINY = {
    "varnet": ["--num_cascades", "1", "--chans", "4", "--sens_chans", "4", "--sens_pools", "2"],
    "cinenet": ["--num_cascades", "1", "--chans", "4", "--CG_iters", "2"],
    "xpdnet": ["--num_cascades", "1", "--crnn_chans", "4", "--sens_chans", "4", "--sens_pools", "2",
               "--n_primal", "2"],
}


def _crnn_argv(family, workdir):
    argv = CRNN_TINY[family] + ["--dynamic_type", "CRNN", "--center_fractions", "6",
                                "--accelerations", "2"]
    return argv, argv + ["--path_config", str(workdir / "dirs_path.yaml"),
                         "--maps_cache_dir", str(workdir / "maps"), "--device", "cpu"]


@pytest.mark.parametrize("family", ["varnet", "cinenet", "xpdnet"])
def test_crnn_cli_trains_and_restores(family, workdir):
    """``--dynamic_type CRNN`` trains one epoch with a final checkpoint in
    the directory the JAX CLI names for the same argv (its fingerprint),
    and ``--mode test --load_model 1`` restores those weights exactly."""
    argv, common = _crnn_argv(family, workdir)
    fp = JC.config_fingerprint(family, JC.build_parser(family).parse_args(argv))
    assert TC.config_fingerprint(family, TC.build_parser(family).parse_args(argv)) == fp
    out = TC.train_test_main(family, common + ["--mode", "train", "--epochs", "1",
                                               "--save_checkpoint", "1"])
    assert np.isfinite(out["history"][-1]["train_loss"])
    trained = out["trainer"].model
    assert type(trained).__name__ == {"varnet": "VarNetRNN", "cinenet": "CineNetRNN",
                                      "xpdnet": "XPDNetRNN"}[family]
    ckpt = workdir / "logs" / family / f"{family}_logs" / "checkpoints" / f"{family}_CRNN_acc2_{fp}"
    assert sorted(p.name for p in ckpt.iterdir()) == ["0.pt", "1.pt", "best_steps.json"]

    out = TC.train_test_main(family, common + ["--mode", "test", "--load_model", "1",
                                               "--inference", "0"])
    assert 0 < out["test_metrics"]["ssim"] <= 1
    restored = out["trainer"].model.state_dict()
    for name, value in trained.state_dict().items():
        torch.testing.assert_close(restored[name], value, rtol=0, atol=0, msg=name)


def test_xpdnet_crnn_norm_buffers_notice(workdir):
    """--norm_buffers with --dynamic_type CRNN is a no-op (XPDNetRNN has no
    MWCNN buffer path): the run says so, as the JAX CLI does, and the
    override notice of the MWCNN variants stays silent."""
    _, common = _crnn_argv("xpdnet", workdir)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = TC.train_test_main("xpdnet", common + ["--mode", "train", "--epochs", "1",
                                                     "--norm_buffers", "1"])
    said = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    assert any("no effect for --dynamic_type CRNN" in m for m in said)
    assert not any("overrides the certified pairing" in m for m in said)
    assert np.isfinite(out["history"][0]["train_loss"])
