"""The port's host data path (``cinemri_tpu_torch.data``, ``.native``) against
the JAX package on the CPU, and the small CineNet chain from a volume to a
served request.

Inputs are made with numpy from a seed and handed to both packages. The data
modules are numpy copies, so what does not go through LAPACK must be
bit-equal (``assert_array_equal``); what goes through an eigendecomposition
(ESPIRiT maps, the targets and coil compression built on them) is held to
``LAPACK_TOL`` x max |value|. The C++ ESPIRiT is held against the numpy one
with the measures of tests/test_native.py; the served CineNet output with
the model tolerance of tests/test_torch_cinenet.py, 1e-4 x max |out|.
"""

import dataclasses
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cinemri_tpu.data as JD
from cinemri_tpu.data import compress as j_compress
from cinemri_tpu.data import dataset as j_dataset
from cinemri_tpu.data import espirit as j_espirit
from cinemri_tpu.data import sharding as j_sharding
from cinemri_tpu.data import synthetic as j_synthetic
from cinemri_tpu.data import transforms as j_transforms
from cinemri_tpu.models import build_model as j_build_model
from cinemri_tpu.ops.cplx import Complex as JComplex

import cinemri_tpu_torch.data as TD
import cinemri_tpu_torch.native as native
from cinemri_tpu_torch.data import compress, dataset, espirit, sharding, synthetic, transforms
from cinemri_tpu_torch.interop.flax_params import cinenet_state_dict
from cinemri_tpu_torch.models import build_model
from cinemri_tpu_torch.serve import bind_model

torch.set_num_threads(2)

LAPACK_TOL = 1e-6  # x max |value|, for results of an eigendecomposition


def close(got, want, tol=LAPACK_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def assert_sample_equal(got, want, lapack=("sens_maps", "target", "max_value")):
    """Every field of a sample (dict or tuple) equal: bit-equal, or to
    LAPACK_TOL for the fields derived from ESPIRiT maps."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        items = [(k, got[k], want[k]) for k in want]
    else:
        assert len(got) == len(want)
        items = [(i, g, w) for i, (g, w) in enumerate(zip(got, want))]
    for key, g, w in items:
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            if key in lapack or (not isinstance(want, dict) and key == 2):
                close(g, w)
            else:
                np.testing.assert_array_equal(g, w, err_msg=str(key))
        elif key in lapack:
            np.testing.assert_allclose(g, w, rtol=LAPACK_TOL)
        else:
            assert g == w, key


@pytest.fixture(scope="module")
def phantom():
    """The 48x48 six-coil phantom of tests/test_espirit.py."""
    return synthetic.synthetic_volume(num_frames=6, num_coils=6, h=48, w=48, seed=3)


class TestSynthetic:
    @pytest.mark.parametrize("kw", [dict(), dict(coil_modes=2), dict(noise=1e-2, seed=5)])
    def test_volume_equals_jax(self, kw):
        got = synthetic.synthetic_volume(num_frames=4, num_coils=4, h=32, w=32, **kw)
        want = j_synthetic.synthetic_volume(num_frames=4, num_coils=4, h=32, w=32, **kw)
        for key in ("kspace", "sens", "image"):
            np.testing.assert_array_equal(got[key], want[key])

    def test_coil_helpers_equal_jax(self):
        np.testing.assert_array_equal(synthetic.coil_sensitivities(5, 20, 24),
                                      j_synthetic.coil_sensitivities(5, 20, 24))
        np.testing.assert_array_equal(
            synthetic.redundant_coil_sensitivities(6, 20, 24, 2, noise=0.02),
            j_synthetic.redundant_coil_sensitivities(6, 20, 24, 2, noise=0.02))
        np.testing.assert_array_equal(synthetic.cine_phantom(5, 20, 24),
                                      j_synthetic.cine_phantom(5, 20, 24))


class TestTransforms:
    def test_filter_normalize_mask_equal_jax(self, rng):
        x = (rng.standard_normal((6, 3, 36, 40)) + 1j * rng.standard_normal((6, 3, 36, 40)))
        x = x.astype(np.complex64)
        for a, b in zip(transforms.filtered_crop_center_and_slices(x, (32, 30), 4, (0.7, 0, 0.3, 0.3)),
                        j_transforms.filtered_crop_center_and_slices(x, (32, 30), 4, (0.7, 0, 0.3, 0.3))):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(transforms.normalize_instance(x.real, eps=1e-6),
                        j_transforms.normalize_instance(x.real, eps=1e-6)):
            np.testing.assert_array_equal(a, b)
        for seed in (7, transforms._fname_seed("vol_03.h5")):
            got = transforms.apply_mask_np(x, TD.RandomMask([4], [2]), seed)
            want = j_transforms.apply_mask_np(x, JD.RandomMask([4], [2]), seed)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert transforms._fname_seed("ab.h5") == j_transforms._fname_seed("ab.h5")

    @pytest.mark.parametrize("name", ["VarNetDataTransform", "XPDNetDataTransform",
                                      "CineNetDataTransform"])
    @pytest.mark.parametrize("kw", [dict(), dict(compress_coils=3)])
    def test_samples_equal_jax(self, name, kw):
        """The filename-seeded mask, a ``mask_seed`` draw and a pre-masked
        sample (no mask function), each field of each sample."""
        vol = synthetic.synthetic_volume(num_frames=4, num_coils=4, h=32, w=32, seed=2)
        got_tf = getattr(transforms, name)(TD.RandomMask([4], [2]), **kw)
        want_tf = getattr(j_transforms, name)(JD.RandomMask([4], [2]), **kw)
        for mask_seed in (None, 11):
            args = (vol["kspace"], None, vol["image"][:, 2:30, 2:30], {}, "train_vol00.h5", 0)
            assert_sample_equal(got_tf(*args, mask_seed=mask_seed), want_tf(*args, mask_seed=mask_seed))
        mask = TD.RandomMask([4], [2])(1, 32, seed=3)
        assert_sample_equal(getattr(transforms, name)(**kw)(vol["kspace"], mask, None, {}, "v.h5", 1),
                            getattr(j_transforms, name)(**kw)(vol["kspace"], mask, None, {}, "v.h5", 1))

    def test_cinenet_maps_cache_equal_jax(self, tmp_path):
        """Maps with the cache off, on in memory, and on disk (a fresh
        transform reads the other's file) against the JAX package's."""
        vol = synthetic.synthetic_volume(num_frames=3, num_coils=3, h=32, w=32, seed=4)
        args = (vol["kspace"], None, vol["image"], {}, "v.h5", 0)
        want = j_transforms.CineNetDataTransform(JD.RandomMask([6], [2]), use_seed=True)(*args)
        for kw in (dict(), dict(cache_maps=True), dict(cache_maps=True, maps_cache_dir=tmp_path)):
            tf = transforms.CineNetDataTransform(TD.RandomMask([6], [2]), **kw)
            for _ in range(2):
                assert_sample_equal(tf(*args), want)
        assert list(tmp_path.glob("v.h5.s0.r15.RandomMask_c6_a2.maps.npz"))
        fresh = transforms.CineNetDataTransform(TD.RandomMask([6], [2]), cache_maps=True,
                                                maps_cache_dir=tmp_path)
        np.testing.assert_array_equal(fresh(*args)["sens_maps"],
                                      np.load(next(tmp_path.glob("*.npz")))["maps"][None])


class TestCompression:
    def test_equal_jax(self):
        vol = synthetic.synthetic_volume(num_frames=4, num_coils=6, h=32, w=32, coil_modes=2, seed=1)
        k, mask = transforms.apply_mask_np(vol["kspace"], TD.RandomMask([6], [2]), 5)
        for m in (mask, None):
            got = compress.compression_matrix(k, 3, m)
            want = j_compress.compression_matrix(k, 3, m)
            close(got, want)
            close(compress.apply_compression(k, got), j_compress.apply_compression(k, want))
            for thr in (0.99, 0.999):
                assert (compress.suggest_num_virtual(k, m, thr)
                        == j_compress.suggest_num_virtual(k, m, thr))


class TestEspirit:
    @pytest.mark.parametrize("calib", [24, 15])
    def test_maps_equal_jax(self, phantom, calib):
        tavg = phantom["kspace"].mean(0)
        got = espirit.espirit_maps(tavg, calib_size=calib, return_eigenvalues=True)
        want = j_espirit.espirit_maps(tavg, calib_size=calib, return_eigenvalues=True)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            close(a, b)
        close(espirit.calibration_matrix_gram(tavg[:, :10, :10].astype(np.complex128), 6),
              j_espirit.calibration_matrix_gram(tavg[:, :10, :10].astype(np.complex128), 6))

    def test_multi_equal_jax(self, phantom):
        tavg = phantom["kspace"].mean(0)
        for kw in (dict(num_maps=2), dict(num_maps=3, crop=0.0)):
            got = espirit.espirit_maps_multi(tavg, return_eigenvalues=True, **kw)
            want = j_espirit.espirit_maps_multi(tavg, return_eigenvalues=True, **kw)
            for a, b in zip(got, want):
                close(a, b)
        with pytest.raises(ValueError, match="num_maps"):
            espirit.espirit_maps_multi(tavg, num_maps=7)


class TestPreprocess:
    def test_preprocess_volume_equals_jax(self):
        vol = synthetic.synthetic_volume(num_frames=5, num_coils=3, h=36, w=32, noise=1e-3, seed=6)
        raw = vol["kspace"].transpose(0, 2, 3, 1) / 1e6
        cfg = dataset.PreprocessConfig().scaled_to(36, 32, 5)
        jcfg = j_dataset.PreprocessConfig().scaled_to(36, 32, 5)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.cache_key() == dataset.PreprocessConfig().scaled_to(36, 32, 5).cache_key()
        got, want = dataset.preprocess_volume(raw, cfg), j_dataset.preprocess_volume(raw, jcfg)
        np.testing.assert_array_equal(got["kspace"], want["kspace"])
        close(got["sens"], want["sens"])
        close(got["target"], want["target"])


class TestSharding:
    def test_equal_jax(self):
        examples = [(f"vol{v}", s) for v in range(5) for s in range(3)]
        for n, rank, shuffle, epoch in ((2, 0, True, 0), (2, 1, True, 3), (3, 2, False, 0),
                                        (4, 1, True, 1), (7, 6, True, 2)):
            assert (sharding.volume_shard_indices(examples, n, rank, shuffle, 5, epoch)
                    == j_sharding.volume_shard_indices(examples, n, rank, shuffle, 5, epoch))
            for drop_last in (False, True):
                assert (sharding.data_shard_indices(15, n, rank, shuffle, 5, epoch, drop_last)
                        == j_sharding.data_shard_indices(15, n, rank, shuffle, 5, epoch, drop_last))
        with pytest.raises(ValueError, match="out of range"):
            sharding.volume_shard_indices(examples, 2, 2)


class TestDataset:
    @pytest.fixture(scope="class")
    def root(self, tmp_path_factory):
        """A tree written by the port: two splits of three volumes, t=4,
        c=3, 32x32."""
        return synthetic.make_synthetic_dataset(tmp_path_factory.mktemp("data"),
                                                splits=("train", "valid"), volumes_per_split=3,
                                                num_frames=4, num_coils=3, h=32, w=32)

    def test_files_equal_jax_writer(self, root, tmp_path):
        import h5py

        j_synthetic.write_hdf5_volume(tmp_path / "v.h5", num_frames=4, num_coils=3, h=32, w=32,
                                      seed=1)
        with h5py.File(tmp_path / "v.h5") as a, h5py.File(root / "train" / "train_vol01.h5") as b:
            np.testing.assert_array_equal(a["y"][()], b["y"][()])

    @pytest.mark.parametrize("kw", [dict(), dict(sample_rate=0.67), dict(volume_sample_rate=0.34),
                                    dict(num_cols=[32]), dict(num_cols=[999])])
    def test_listing_equals_jax(self, root, kw):
        random.seed(3)
        got = dataset.SliceDataset(root / "train", **kw)
        random.seed(3)
        want = j_dataset.SliceDataset(root / "train", **kw)
        assert len(got) == len(want)
        assert [tuple(e) for e in got.examples] == [tuple(e) for e in want.examples]

    @pytest.mark.parametrize("transform", ["CineNetDataTransform", None])
    def test_samples_equal_jax(self, root, tmp_path, transform):
        """Every field of every sample, through the .npz decode cache (the
        second pass) and the RAM LRU, with and without a mask seed."""
        def make(pkg, tf_mod, ds_mod, cache):
            tf = None if transform is None else getattr(tf_mod, transform)(pkg.RandomMask([4], [2]))
            return ds_mod.SliceDataset(root / "train", transform=tf, maps_cache_dir=cache,
                                       ram_cache_volumes=1)

        got = make(TD, transforms, dataset, tmp_path / "port")
        want = make(JD, j_transforms, j_dataset, tmp_path / "jax")
        for _ in range(2):
            for i in range(len(want)):
                for mask_seed in (None, 100 + i):
                    assert_sample_equal(got.load(i, mask_seed=mask_seed),
                                        want.load(i, mask_seed=mask_seed))
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
            p.name for p in (tmp_path / "jax").iterdir())

    def test_combined_equals_jax(self, root):
        roots = [root / "train", root / "valid"]
        got = dataset.CombinedSliceDataset(
            roots, [transforms.VarNetDataTransform(TD.RandomMask([4], [2]))] * 2)
        want = j_dataset.CombinedSliceDataset(
            roots, [j_transforms.VarNetDataTransform(JD.RandomMask([4], [2]))] * 2)
        assert len(got) == len(want) == 6
        assert [tuple(e) for e in got.examples] == [tuple(e) for e in want.examples]
        for i in (0, 4):
            assert_sample_equal(got.load(i, mask_seed=i), want.load(i, mask_seed=i))
        with pytest.raises(IndexError):
            got.load(6)
        with pytest.raises(ValueError, match="not both"):
            dataset.CombinedSliceDataset(roots, sample_rates=[1, 1], volume_sample_rates=[1, 1])


class TestNative:
    """The port's C++ ESPIRiT, built by g++ into cinemri_tpu_torch/_build/,
    against the port's numpy ESPIRiT with tests/test_native.py's measures."""

    @pytest.fixture(scope="class")
    def vol(self):
        return synthetic.synthetic_volume(num_frames=4, num_coils=5, h=40, w=40, seed=7)

    @pytest.fixture(scope="class")
    def maps_pair(self, vol):
        tavg = vol["kspace"].mean(0)
        return (*espirit.espirit_maps(tavg, calib_size=24, return_eigenvalues=True),
                *native.espirit_maps_native(tavg, calib_size=24, return_eigenvalues=True))

    def test_builds_into_the_port_only(self, maps_pair):
        from pathlib import Path

        jax_tree = Path(j_dataset.__file__).resolve().parents[1]

        def listing():
            return sorted(str(p.relative_to(jax_tree)) for p in jax_tree.rglob("*")
                          if "__pycache__" not in p.parts)

        before = listing()
        from cinemri_tpu_torch.utils import compile_cache

        lib = native.build_library(force=True)
        assert lib == native.library_path()
        # the compile cache's directory: by default the port's _build/<host fingerprint>
        assert lib.parent == compile_cache.build_dir()
        if not os.environ.get("CINEMRI_COMPILE_CACHE"):
            assert lib.parent == (Path(native.__file__).resolve().parents[1] / "_build"
                                  / compile_cache.host_fingerprint())
        assert lib.exists() and lib.stat().st_mtime >= (Path(native.__file__).parent / "espirit.cc").stat().st_mtime
        assert listing() == before

    def test_matches_numpy(self, maps_pair):
        py_maps, py_eig, cc_maps, cc_eig = maps_pair
        np.testing.assert_allclose(cc_eig, py_eig, atol=5e-3)
        sup = py_eig > 0.9
        err = np.abs(np.abs(cc_maps) - np.abs(py_maps))[:, sup]
        assert np.median(err) < 1e-4
        assert np.quantile(err, 0.99) < 2e-2
        sup = (py_eig > 0.9) & (cc_eig > 0.9)
        inner = np.abs((py_maps.conj() * cc_maps).sum(axis=0))[sup]
        assert np.median(inner) > 0.999
        assert np.quantile(inner, 0.01) > 0.95

    def test_engine_and_env_route_preprocess(self, vol, monkeypatch):
        raw = vol["kspace"].transpose(0, 2, 3, 1) / 1e6
        base = dataset.PreprocessConfig().scaled_to(40, 40, 4)
        calls = []
        real = native.espirit_maps_native
        monkeypatch.setattr(native, "espirit_maps_native",
                            lambda *a, **k: (calls.append(1), real(*a, **k))[1])
        out_np = dataset.preprocess_volume(raw, base)
        assert calls == []
        out_nat = dataset.preprocess_volume(raw, dataclasses.replace(base, espirit_engine="native"))
        assert calls == [1]
        a, b = out_np["target"], out_nat["target"]
        np.testing.assert_allclose(a / a.max(), b / a.max(), atol=5e-3)
        monkeypatch.setenv("CINEMRI_ESPIRIT_ENGINE", "native")
        dataset.preprocess_volume(raw, base)
        assert calls == [1, 1]


def test_cinenet_chain_matches_jax():
    """Synthetic volume -> preprocess_volume -> CineNetDataTransform -> one
    request through ``bind_model(device="cpu")``, against the JAX package's
    CineNet on the JAX package's sample. CineNet-XF with 2 cascades, 2 CG
    iterations, chans 4, pools 2; weights carried by cinenet_state_dict.

    Noise 3e-2: CineNet's U-Nets (no normalizing wrapper) instance-normalize
    each (w, t) and (h, t) plane after the temporal mean is taken out, so
    on a phantom whose body is static a plane holds little more than f32
    rounding, and normalizing it makes the output depend on that rounding.
    At noise 1e-3 a 1e-7 relative change of the k-space moves the port's
    own output by 1.4-2.1e-4 x max |out| (JAX and the port then differ by
    1.6-3.3e-4); at 3e-2 by 1.0-1.3e-5, and they differ by 1.2-1.5e-5
    (seeds 1, 2, 3, 8)."""
    vol = synthetic.synthetic_volume(num_frames=5, num_coils=3, h=32, w=32, noise=3e-2, seed=8)
    raw = vol["kspace"].transpose(0, 2, 3, 1) / 1e6
    args = lambda d: (d["kspace"], None, d["target"], {}, "chain.h5", 0)
    got_dec = dataset.preprocess_volume(raw, dataset.PreprocessConfig().scaled_to(32, 32, 5))
    want_dec = j_dataset.preprocess_volume(raw, j_dataset.PreprocessConfig().scaled_to(32, 32, 5))
    s = transforms.CineNetDataTransform(TD.RandomMask([4], [2]))(*args(got_dec))
    js = j_transforms.CineNetDataTransform(JD.RandomMask([4], [2]))(*args(want_dec))
    assert_sample_equal(s, js)

    cfg = dict(num_cascades=2, cg_iters=2, chans=4, pools=2)
    jk = JComplex(jnp.asarray(js["masked_kspace"].real[None]), jnp.asarray(js["masked_kspace"].imag[None]))
    jmask = jnp.asarray(js["mask"][None])
    jsens = JComplex(jnp.asarray(js["sens_maps"].real[None]), jnp.asarray(js["sens_maps"].imag[None]))
    jm = j_build_model("cinenet", "XF", **cfg)
    params = jm.init(jax.random.PRNGKey(0), jk, jmask, jsens)
    want = np.asarray(jm.apply(params, jk, jmask, jsens))

    model = build_model("cinenet", "XF", device="cpu", **cfg)
    serve = bind_model(model, cinenet_state_dict(jax.tree.map(np.asarray, params)), device="cpu")
    k, sens = s["masked_kspace"][None], s["sens_maps"][None]
    got = serve(k.real, k.imag, s["mask"][None], sens.real, sens.imag).numpy()
    assert got.shape == want.shape == (1, 5, 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
