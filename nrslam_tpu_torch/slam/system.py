"""The steady-state SLAM frame (counterpart of ``frame_step`` /
``_fused_frame_impl`` in nrslam_tpu/slam/system.py).

One frame = pyramid + tracking + mapping, then the LOST freeze: once the
collapse latch is set, every later frame returns the old state unchanged
(the reference exits at the collapse frame, tracking.cc:97-99).
"""

from __future__ import annotations

import torch

from nrslam_tpu_torch.geometry import cameras
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import mapping as mapping_mod
from nrslam_tpu_torch.slam import tracking as tracking_mod
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils import tree


def frame_step(state, gray, mask, cam: cameras.Camera, config: Config,
               make_keyframe: bool):
    """One steady-state SLAM frame (System::TrackImage after init).
    Returns (state, tracking.FrameResult)."""
    old = state
    pyramid = klt.build_pyramid(gray, config.klt_config)
    state, result = tracking_mod.process_frame(state, pyramid, mask, cam,
                                               config, make_keyframe)
    state = mapping_mod.do_mapping(state, cam, config,
                                   has_new_keyframe=make_keyframe)
    state = tree.where(old.lost, old, state)
    result = result._replace(
        n_tracked_3d=torch.where(old.lost, torch.zeros_like(
            result.n_tracked_3d), result.n_tracked_3d),
        lost=old.lost | result.lost)
    return state, result
