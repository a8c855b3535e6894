"""The port's reference-checkpoint import (cinemri_tpu_torch.interop) against
the JAX package's on the CPU.

No reference code is on this machine, so each checkpoint is written in the
reference's layout by ``interop.reference_layout`` from a seed. Each one is
proved complete by the JAX package's ``check_tree_matches`` against a fresh
``init`` of the model its import names, the port's import is held
bit-exactly to ``flax_params.<family>_state_dict`` of the JAX package's
imported tree, and the model built from it to the JAX forward on the same
inputs within 1e-4 x max |out| (the families' tolerance in
tests/test_torch_models.py, test_torch_cinenet.py, test_torch_xpdnet.py and
test_torch_crnn.py). Then the JAX package's error cases, the hparam
translation, and ``--from_torch_ckpt`` through the CLI in ``--mode train``,
``test`` and ``export``.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cinemri_tpu.interop import build_kwargs_from_hparams as j_build_kwargs
from cinemri_tpu.interop import check_tree_matches as j_check_tree_matches
from cinemri_tpu.interop import import_torch_checkpoint as j_import
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops.cplx import Complex as JComplex

from cinemri_tpu_torch.cli import common as TC
from cinemri_tpu_torch.data.synthetic import make_synthetic_dataset
from cinemri_tpu_torch.interop import (
    build_kwargs_from_hparams,
    check_tree_matches,
    flax_params,
    import_torch_checkpoint,
)
from cinemri_tpu_torch.interop.reference_layout import reference_checkpoint, reference_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.ops.cplx import from_complex
from cinemri_tpu_torch.serve import load_exported

torch.set_num_threads(2)

VARNET = dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=4, pools=2)
CINENET = dict(num_cascades=2, CG_iters=2, chans=4, pools=2)
XPDNET = dict(num_cascades=2, sens_chans=4, sens_pools=2, n_scales=2, n_filters_per_scale=[4, 8],
              n_convs_per_scale=[2, 2], n_first_convs=1, first_conv_n_filters=6, n_primal=3,
              primal_only=True, n_dual=1, res=False)

# (id, family, the checkpoint's hyper_parameters)
CASES = [
    ("varnet-XF", "varnet", dict(VARNET, dynamic_type="XF", weight_sharing=False)),
    ("varnet-XT", "varnet", dict(VARNET, dynamic_type="XT")),
    ("varnet-2D", "varnet", dict(VARNET, dynamic_type="2D")),
    ("varnet-3D", "varnet", dict(VARNET, dynamic_type="3D")),
    ("varnet-CRNN", "varnet", dict(num_cascades=2, sens_chans=4, sens_pools=2, chans=6,
                                   dynamic_type="CRNN")),
    ("cinenet-XF", "cinenet", dict(CINENET, dynamic_type="XF")),
    ("cinenet-2D", "cinenet", dict(CINENET, dynamic_type="2D")),
    ("cinenet-CRNN", "cinenet", dict(num_cascades=2, CG_iters=2, chans=6, dynamic_type="CRNN")),
    ("xpdnet-XF-pair", "xpdnet", dict(XPDNET, dynamic_type="XF")),
    ("xpdnet-XF-shared", "xpdnet", dict(XPDNET, dynamic_type="XF", weight_sharing=True)),
    ("xpdnet-XF-dual", "xpdnet", dict(XPDNET, dynamic_type="XF", primal_only=False, n_dual=2)),
    ("xpdnet-CRNN", "xpdnet", dict(num_cascades=2, sens_chans=4, sens_pools=2, crnn_chans=6,
                                   n_primal=3, dynamic_type="CRNN")),
]

_STATE_DICTS = {
    "varnet": (flax_params.varnet_state_dict, flax_params.varnet_rnn_state_dict),
    "cinenet": (flax_params.cinenet_state_dict, flax_params.cinenet_rnn_state_dict),
    "xpdnet": (flax_params.xpdnet_state_dict, flax_params.xpdnet_rnn_state_dict),
}


def _save(tmp_path, family, hparams, seed=0):
    path = tmp_path / f"{family}.ckpt"
    torch.save(reference_checkpoint(family, hparams, seed), path)
    return path


def _inputs(seed, family, t=4, c=3, h=16, w=16):
    """Masked k-space, a line mask and, for CineNet, RSS-normalized maps."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((1, t, 1, h, 1), np.float32)
    mask[:, :, :, h // 2 - 2:h // 2 + 2] = 1
    mask[:, :, :, rng.choice(h, size=h // 3, replace=False)] = 1
    k = (rng.standard_normal((1, t, c, h, w)) + 1j * rng.standard_normal((1, t, c, h, w)))
    k = (k * mask).astype(np.complex64)
    if family != "cinenet":
        return k, mask, None
    s = (rng.standard_normal((1, 1, c, h, w)) + 1j * rng.standard_normal((1, 1, c, h, w)))
    s /= np.sqrt((np.abs(s) ** 2).sum(2, keepdims=True))
    return k, mask, s.astype(np.complex64)


def _jc(x):
    return JComplex(jnp.asarray(x.real), jnp.asarray(x.imag))


@pytest.mark.parametrize("family, hparams", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_import_is_bit_exact_to_jax_and_forwards_like_it(tmp_path, family, hparams):
    path = _save(tmp_path, family, hparams, seed=3)
    jvars, jkw, jfam, jdyn = j_import(path)
    state_dict, kw, fam, dyn = import_torch_checkpoint(path)
    assert (fam, dyn, kw) == (jfam, jdyn, jkw) == (family, hparams["dynamic_type"], jkw)
    want = _STATE_DICTS[family][dyn == "CRNN"](jax.tree.map(np.asarray, jvars))
    assert state_dict.keys() == want.keys()
    for key, value in state_dict.items():
        assert value.dtype == torch.float32 and torch.equal(value, want[key]), key

    model = build_model(family, dyn, device="cpu", **kw)
    check_tree_matches(state_dict, model)
    model.load_state_dict(state_dict)
    k, mask, s = _inputs(1, family)
    args = (from_complex(k), torch.from_numpy(mask)) + ((from_complex(s),) if s is not None else ())
    with torch.no_grad():
        got = model(*args).numpy()
    assert np.isfinite(got).all()
    if hparams.get("weight_sharing") and dyn in ("XF", "XT") and family == "xpdnet":
        # the JAX package's XPDNet XF with weight_sharing raises flax's
        # NameInUseError at init (ROADMAP Queue 3): the import is held
        # bit-exactly above, the forward only to its own finiteness
        return
    jm = j_build_model(family, dyn, **jkw)
    jargs = (_jc(k), jnp.asarray(mask)) + ((_jc(s),) if s is not None else ())
    # the generated checkpoint holds every weight the model initializes
    j_check_tree_matches(jvars, jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jargs))
    ref = np.asarray(jm.apply(jvars, *jargs))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


class TestErrorHandling:
    def test_family_mismatch_raises(self, tmp_path):
        path = _save(tmp_path, "cinenet", dict(CINENET, dynamic_type="2D"))
        with pytest.raises(ValueError, match="cinenet"):
            import_torch_checkpoint(path, family="varnet")

    def test_unknown_prefix_needs_family(self, tmp_path):
        path = tmp_path / "bare.ckpt"
        torch.save({"something.weight": torch.zeros(3)}, path)
        with pytest.raises(ValueError, match="cannot detect"):
            import_torch_checkpoint(path)

    def test_check_tree_matches_reports_missing_unexpected_and_shape_diff(self):
        model = build_model("cinenet", "2D", device="cpu", num_cascades=2, cg_iters=2, chans=4,
                            pools=2)
        sd = dict(model.state_dict())
        check_tree_matches(sd, model)
        first, second = list(sd)[:2]
        sd["extra.weight"] = torch.zeros(1)
        del sd[first]
        sd[second] = torch.zeros(sd[second].shape[0] + 1, *sd[second].shape[1:])
        with pytest.raises(ValueError, match="missing from checkpoint") as err:
            check_tree_matches(sd, model)
        assert "unexpected in checkpoint: ['extra.weight']" in str(err.value)
        assert f"shape mismatches: {second}" in str(err.value)

    def test_bare_state_dict_with_family(self, tmp_path):
        """A raw model.state_dict() (no Lightning wrapper, no prefix) imports
        when the family is given explicitly; it has no hparams."""
        hp = dict(CINENET, dynamic_type="2D")
        path = tmp_path / "bare.ckpt"
        torch.save(reference_state_dict("cinenet", hp), path)
        state_dict, kwargs, family, dyn = import_torch_checkpoint(path, family="cinenet",
                                                                  dynamic_type="2D")
        assert (family, dyn, kwargs) == ("cinenet", "2D", {})
        assert {k.split(".")[1] for k in state_dict if k.startswith("cascades.")} == {"net"}
        jvars, *_ = j_import(path, family="cinenet", dynamic_type="2D")
        want = flax_params.cinenet_state_dict(jax.tree.map(np.asarray, jvars))
        assert all(torch.equal(state_dict[k], want[k]) for k in want)


_HPARAMS = [
    ("varnet", dict(VARNET, weight_sharing=True, lr=1e-4), "XF"),
    ("varnet", dict(VARNET, lr=1e-4), "CRNN"),
    ("cinenet", dict(CINENET, weight_sharing=False), "XF"),
    ("cinenet", dict(CINENET), "CRNN"),
    ("xpdnet", dict(XPDNET, weight_sharing=False), "XF"),
    ("xpdnet", {"num_cascades": 3, "sens_chans": 8, "sens_pools": 3, "crnn_chans": 18,
                "n_primal": 5, "lr": 3e-4}, "CRNN"),
]


@pytest.mark.parametrize("family, hparams, dynamic_type", _HPARAMS,
                         ids=[f"{f}-{d}" for f, _, d in _HPARAMS])
def test_hparam_translation_matches_jax(family, hparams, dynamic_type):
    got = build_kwargs_from_hparams(family, hparams, dynamic_type)
    assert got == j_build_kwargs(family, hparams, dynamic_type)
    assert all(not isinstance(v, list) for v in got.values())


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The JAX CLI test's tree: one 4-frame, 3-coil, 32x32 volume per split."""
    root = tmp_path_factory.mktemp("interopcli")
    make_synthetic_dataset(root / "data", splits=("train", "valid", "test"), volumes_per_split=1,
                           num_frames=4, num_coils=3, h=32, w=32)
    with open(root / "dirs_path.yaml", "w") as f:
        yaml.dump({"data_path": str(root / "data"), "log_path": str(root / "logs"),
                   "save_path": str(root / "results")}, f)
    return root


class TestCLITorchCkpt:
    HP = {"num_cascades": 1, "sens_chans": 4, "sens_pools": 2, "chans": 4, "pools": 2,
          "dynamic_type": "XF", "weight_sharing": False}
    ARGV = ["--path_config", None, "--num_cascades", "1", "--chans", "4", "--sens_chans", "4",
            "--sens_pools", "2", "--pools", "2", "--dynamic_type", "XF",
            "--center_fractions", "6", "--accelerations", "2", "--device", "cpu"]

    def _argv(self, workdir, *extra):
        argv = list(self.ARGV)
        argv[1] = str(workdir / "dirs_path.yaml")
        return argv + list(extra)

    def test_mode_test_train_and_export_with_from_torch_ckpt(self, workdir, tmp_path):
        """--from_torch_ckpt end to end: evaluate the reference checkpoint's
        weights (no port checkpoint present), fine-tune from them, and
        export them; the exported artifact serves as the imported model."""
        ckpt = _save(tmp_path, "varnet", self.HP, seed=5)
        state_dict, *_ = import_torch_checkpoint(ckpt)
        out = TC.train_test_main("varnet", self._argv(workdir, "--mode", "test", "--inference",
                                                      "0", "--from_torch_ckpt", str(ckpt)))
        assert np.isfinite(out["test_metrics"]["ssim"])
        # the loaded weights are the checkpoint's, not a random init
        got = out["trainer"].state.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in state_dict.items())

        out = TC.train_test_main("varnet", self._argv(workdir, "--mode", "train", "--epochs", "1",
                                                      "--from_torch_ckpt", str(ckpt)))
        assert np.isfinite(out["history"][-1]["train_loss"])
        assert int(out["trainer"].state.step) == 1  # one step from the imported weights

        path = tmp_path / "served.pt2"
        out = TC.train_test_main("varnet", self._argv(workdir, "--mode", "export", "--export_path",
                                                      str(path), "--from_torch_ckpt", str(ckpt)))
        assert out["export_path"] == str(path)
        model = build_model("varnet", "XF", device="cpu", **{k: v for k, v in self.HP.items()
                                                              if k != "dynamic_type"})
        model.load_state_dict(state_dict)
        first = out["trainer"].test_loader.first_batch()
        k, mask = from_complex(first["masked_kspace"]), torch.from_numpy(first["mask"])
        with torch.inference_mode():
            want = model.eval()(k, mask)
        torch.testing.assert_close(load_exported(path)(k.re, k.im, mask), want, rtol=0, atol=0)

    def test_dynamic_type_mismatch_raises(self, tmp_path):
        ckpt = _save(tmp_path, "varnet", {**self.HP, "num_cascades": 1})
        args = Namespace(from_torch_ckpt=ckpt, dynamic_type="2D", weight_sharing=False)
        with pytest.raises(ValueError, match="varnet-XF"):
            TC._apply_torch_ckpt(None, "varnet", args)
