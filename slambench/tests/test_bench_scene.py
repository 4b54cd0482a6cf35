"""The traffic generator: seeded, periodic, with its blackout schedule."""

import numpy as np
import pytest
import torch

from slambench import scene
from slambench.reference.geometry import cameras
from slambench.tests import _small


def _cam(kind):
    if kind == "kb8":
        return cameras.kannala_brandt8(60.0, 60.0, 31.5, 23.5, -0.01, 0.02,
                                       -0.01, 0.002, device="cpu")
    return cameras.pinhole(60.0, 60.0, 31.5, 23.5, device="cpu")


def _stream(mix, seed, kind="pinhole", frames=40):
    mix = mix._replace(loop_frames=frames)
    return scene.Stream(scene.render_loop(_cam(kind), 48, 64, mix), mix,
                        scene.start_frame(mix, seed))


def test_mixes_load_and_name_their_fields():
    mix = scene.load_mix("sweep_blackout")
    assert mix.loop_frames == 240 and mix.speed > 0 and mix.why


def test_same_seed_same_frames_other_start_other_frames():
    for mix, kind in ((_small.steady_mix(), "pinhole"),
                      (scene.load_mix("sweep_blackout"), "kb8")):
        n = max(40, 2 * scene.cycle(mix))   # whole blackout cycles
        a = _stream(mix, 2 ** 33 + 7, kind, n)
        b = _stream(mix, 2 ** 33 + 7, kind, n)
        other = next(s for s in range(2 ** 33 + 8, 2 ** 33 + 99)
                     if scene.start_frame(mix._replace(loop_frames=n), s)
                     != a.start)
        c = _stream(mix, other, kind, n)
        fa, fb, fc = ([s.frame(f) for f in range(40)] for s in (a, b, c))
        assert fa[0].dtype == np.uint8 and fa[0].shape == (48, 64)
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
        assert not all(np.array_equal(x, y) for x, y in zip(fa, fc))


def test_every_seed_meets_the_same_work():
    """The seed picks only the cycle the stream starts on: every seed
    meets the same loop frames, with its blackouts at the same ones."""
    for mix in (scene.load_mix("sweep_blackout"), _small.steady_mix()):
        c = scene.cycle(mix)
        seen = set()
        for seed in (0, 3, 2 ** 31 + 17, 2 ** 40 + 1, -9, 77):
            start = scene.start_frame(mix, seed)
            assert start % c == 0 and 0 <= start < mix.loop_frames
            s = scene.Stream(np.arange(mix.loop_frames)[:, None], mix, start)
            seen.add(frozenset((int(s.frame(f)[0]), s.is_black(f))
                               for f in range(mix.loop_frames)))
        assert len(seen) == 1


def test_a_loop_of_part_cycles_is_refused(tmp_path, monkeypatch):
    (tmp_path / "odd.json").write_text(
        '{"loop_frames": 50, "speed": 0.05, "depth_swing": 0.3, '
        '"rotation": 0.05, "visible": 16, "blackout": 4}')
    monkeypatch.setattr(scene, "TRAFFIC_DIR", tmp_path)
    with pytest.raises(ValueError):
        scene.load_mix("odd")


def test_frame_L_is_frame_0():
    mix = _small.steady_mix()
    cam = _cam("pinhole")
    T0 = scene.camera_pose(0, mix, "cpu")
    TL = scene.camera_pose(mix.loop_frames, mix, "cpu")
    assert torch.allclose(T0.q, TL.q, atol=1e-6)
    assert torch.allclose(T0.t, TL.t, atol=1e-5)
    g0, _ = scene.render(0, cam, 48, 64, mix)
    gL, _ = scene.render(mix.loop_frames, cam, 48, 64, mix)
    assert float((g0 - gL).abs().max()) < 0.05
    # and the loop moves: frame 1 is not frame 0
    g1, _ = scene.render(1, cam, 48, 64, mix)
    assert float((g0 - g1).abs().max()) > 1.0


def test_blackout_schedule():
    mix = scene.load_mix("sweep_blackout")
    v, b = mix.visible, mix.blackout
    assert v > 0 and b > 0
    black = [scene.is_black(mix, f) for f in range(2 * (v + b))]
    assert black[:v] == [False] * v and black[v:v + b] == [True] * b
    assert black[v + b:2 * v + b] == [False] * v
    assert black[2 * v + b:] == [True] * b
    assert not any(scene.is_black(_small.steady_mix(), f)
                   for f in range(500))
    assert mix.loop_frames % (mix.visible + mix.blackout) == 0
    loop = np.full((mix.loop_frames, 2, 2), 7, dtype=np.uint8)
    s = scene.Stream(loop, mix)
    assert s.frame(v + 1).max() == 0 and s.frame(v - 1).min() == 7
