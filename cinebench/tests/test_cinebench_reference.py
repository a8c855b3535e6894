"""The reference against the port with its plain backends, on the CPU at
small sizes: both configurations' forward and VarNet-XF's checked train
steps, as a run compares them."""

import time

import pytest
import torch

from cinebench.harness import bench, check
from cinebench.loops import serve_closed, train
from cinebench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", ["varnet_xf.serve", "cinenet_xf.serve"])
def test_forward_matches_the_reference(name):
    cell = tiny_cell(name)
    dev = torch.device("cpu")
    pool, requests, weights, serve = serve_closed.setup(cell, 2 ** 31 + 7, dev,
                                                      bench.Phases(time.perf_counter()))
    images = [(k, serve(*r)) for k, r in enumerate(requests)]
    gaps = check.image_gaps(images, serve_closed.reference(cell, weights, pool))
    assert gaps["image_rel_l2"] < 2e-5 and gaps["image_rel_max"] < 5e-5, gaps


def test_train_steps_match_the_reference():
    cell = tiny_cell("varnet_xf.train")
    dev = torch.device("cpu")
    pool, _, weights, _, _, prog = train.setup(cell, 2 ** 31 + 8, dev,
                                              bench.Phases(time.perf_counter()))
    gaps = check.train_gaps(prog, train.reference(cell, weights, pool))
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_norm_gap"] < 2e-3, gaps
    assert gaps["change_norm_gap"] < 1e-2, gaps


def test_the_same_seed_gives_the_same_inputs_and_weights():
    from cinebench.harness import volumes
    from cinebench.harness.weights import draw_weights

    shape = {"t": 4, "c": 2, "h": 16, "w": 16}
    traffic = {"center_lines": 4, "acceleration": 4, "noise": 0.03}
    a = volumes.make_volumes(2 ** 31 + 99, 2, shape, traffic, "cpu")
    b = volumes.make_volumes(2 ** 31 + 99, 2, shape, traffic, "cpu")
    for x, y in zip(a, b):
        for key in x:
            assert torch.equal(x[key], y[key])
    assert not torch.equal(a[0]["kspace"], a[1]["kspace"])
    shapes = {"a.weight": (4, 2, 3, 3), "a.bias": (4,), "lambda_reg": (3,)}
    w1 = draw_weights(shapes, 5, {"lambda_reg": 0.5}, "cpu")
    assert all(torch.equal(w1[n], draw_weights(shapes, 5, {"lambda_reg": 0.5}, "cpu")[n]) for n in w1)
    assert w1["a.weight"].abs().max() <= 1 / 18 ** 0.5 and (w1["lambda_reg"] - 0.5).abs().max() <= 0.25
