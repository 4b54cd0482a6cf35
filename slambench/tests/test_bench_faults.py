"""The check fails a run whose timed path is broken underneath: the
harness's run on the CPU (no look for a card) with the port's frame step
broken in each way a cell can break (a step that returns its state
unchanged, half of the map left out of the update, map points altered
where the step makes them: a quarter of them, or one in 32, which a 95th
percentile passes; one card, so no exchange between chips), held to the
benchmark's cell's limits."""

import pytest
import torch

from slambench import check, run
from slambench.tests import _small


def _unchanged(step):
    def broken(state, gray, mask, cam, config, make_keyframe):
        _, res = step(state, gray, mask, cam, config, make_keyframe)
        return state, res
    return broken


def _half_left_out(step):
    def broken(state, gray, mask, cam, config, make_keyframe):
        new, res = step(state, gray, mask, cam, config, make_keyframe)
        half = torch.arange(new.positions.shape[0]) >= (
            new.positions.shape[0] // 2)
        return new._replace(
            positions=torch.where(half[:, None], state.positions,
                                  new.positions),
            status=torch.where(half, state.status, new.status)), res
    return broken


def _answer_altered(step):
    def broken(state, gray, mask, cam, config, make_keyframe):
        new, res = step(state, gray, mask, cam, config, make_keyframe)
        quarter = (torch.arange(new.positions.shape[0]) % 4 == 0)[:, None]
        return new._replace(positions=torch.where(
            quarter, new.positions + 1e-2, new.positions)), res
    return broken


def _few_altered(step):
    def broken(state, gray, mask, cam, config, make_keyframe):
        new, res = step(state, gray, mask, cam, config, make_keyframe)
        few = (torch.arange(new.positions.shape[0]) % 32 == 7)[:, None]
        return new._replace(positions=torch.where(
            few, new.positions + 2e-2, new.positions)), res
    return broken


def _run():
    cfg = _small.config(kb8=False, relost=False)
    limits = check.load_limits("kb8-320-p384.relost")
    return run.run_cell({"name": "small"}, cfg, _small.steady_mix(),
                        limits, 2 ** 36 + 5, 0.5, False, torch.device("cpu"),
                        log=lambda s: None)


@pytest.mark.parametrize("fault", [None, _unchanged, _half_left_out,
                                   _answer_altered, _few_altered])
def test_check_catches_a_broken_step(fault, monkeypatch):
    from nrslam_tpu_torch.slam import system
    torch.set_num_threads(2)
    if fault is not None:
        monkeypatch.setattr(system, "frame_step", fault(system.frame_step))
    out = _run()
    assert out["correct"] is (fault is None), (out["checks"],
                                               out["readings"])
