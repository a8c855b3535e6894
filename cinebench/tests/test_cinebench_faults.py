"""A run with the timed path broken underneath comes out not correct.

The harness is driven without its look for a card, on the CPU at small
sizes: an answer altered where it is produced (one served image scaled),
and a train step that returns its state unchanged. The cells' other faults
do not apply: their batch is one volume and they run on one chip.
"""

import time

import pytest
import torch

from cinebench.harness import bench, program
from cinebench.tests.tiny import CPU_INFO, tiny_cell


def _run(name):
    return bench.run_cell(tiny_cell(name), 2 ** 31 + 3, 0.5, False, time.perf_counter(),
                          torch.device("cpu"), CPU_INFO)


@pytest.mark.parametrize("name", ["varnet_xf.serve", "cinenet_xf.serve", "varnet_xf.train"])
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"
    assert result["setup_phases_s"]["built"] == [] and "build" in result["setup_phases_s"]
    assert result["host"]["proc_cpu_s"] > 0 and result["host"]["threads"] >= 1


@pytest.mark.parametrize("name", ["varnet_xf.serve", "cinenet_xf.serve"])
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    bind = program.bind

    def altered(model, device):
        serve = bind(model, device)
        calls = [0]

        def wrong(*args):
            calls[0] += 1
            image = serve(*args)
            # after the one warm-up request, the window's first, which is always compared
            return image * 1.25 if calls[0] == 2 else image

        return wrong

    monkeypatch.setattr(program, "bind", altered)
    assert not _run(name)["correct"]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    make = program.train_state

    def still(model, opt, device):
        state, step = make(model, opt, device)

        def no_update(state, batch, stop=False):
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            state, aux = step(state, batch, stop)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(before[n])
            return state, aux

        return state, no_update

    monkeypatch.setattr(program, "train_state", still)
    result = _run("varnet_xf.train")
    assert not result["correct"]
    assert result["compared"]["change_norm_gap"]["value"] == pytest.approx(1.0)
