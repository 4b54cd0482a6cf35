"""The frozen reference agrees with the port's eager System on the CPU
(both run the plain drivers there) over the init and a keyframe."""

import torch

from slambench import check, run, scene
from slambench.reference.slam import system as ref_system
from slambench.tests import _small


def test_reference_matches_the_port_over_init_and_a_keyframe():
    torch.manual_seed(0)
    cfg = _small.config(kb8=False, relost=False)
    prog = run.program_setup(cfg, torch.device("cpu"))
    cam, config, icfg = check.reference_setup(cfg, "cpu")
    ref = ref_system.System(cam, config, icfg, seed=4)
    mix = _small.steady_mix()
    loop = scene.render_loop(cam, 240, 320, mix)
    stream = scene.Stream(loop, mix)
    kf_seen, init_at = 0, None
    for f in range(40):
        a = prog.track_image(stream.frame(f))
        b = ref.track_image(stream.frame(f))
        assert a["status"] == b["status"], f
        if a["status"] == "TRACKING" and init_at is None:
            init_at = f
            nums = check.state_gaps(prog.state, ref.state)
            assert nums == {"pose_gap": 0.0, "map_gap": 0.0,
                            "map_gap_max": 0.0, "status_mismatch": 0.0}
        kf_seen += bool(a.get("keyframe"))
        if kf_seen:
            break
    assert init_at is not None and kf_seen == 1
    nums = check.state_gaps(prog.state, ref.state)
    assert nums == {"pose_gap": 0.0, "map_gap": 0.0, "map_gap_max": 0.0,
                    "status_mismatch": 0.0}
    assert torch.equal(prog.state.kf_pose.q, ref.state.kf_pose.q)
    assert torch.equal(prog.state.positions, ref.state.positions)
