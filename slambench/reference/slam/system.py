"""The plain SLAM driver: map bootstrap, the steady frame and the
initialisation loop of ``nrslam_tpu_torch/slam/system.py``, every frame
run eagerly (``frame_step``) with the plain solvers, on whatever device
its tensors are on (reference system.{h,cc}).

``System.track_image`` sequences init and steady frames as the port's
``System`` does: the same keyframe cadence, LOST latch with
``auto_reinitialize``, RANSAC draws from (``seed``, init attempt) and the
reset on the first frame after a loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from slambench.reference.geometry import cameras, se3
from slambench.reference.ops import image as image_ops
from slambench.reference.ops import klt
from slambench.reference.slam import graph as graph_mod
from slambench.reference.slam import initializer as init_mod
from slambench.reference.slam import mapping as mapping_mod
from slambench.reference.slam import state as state_mod
from slambench.reference.slam import tracking as tracking_mod
from slambench.reference.slam.state import Config
from slambench.reference.utils import stats, tree

NOT_INITIALIZED = "NOT_INITIALIZED"
TRACKING = "TRACKING"
LOST = "LOST"


def bootstrap_map(state, result: init_mod.InitializationResult, pyramid,
                  config: Config):
    """The initial map from a successful rigid initialisation
    (Tracking::MonocularMapInitialization, tracking.cc:136-214): scale to
    median depth 3, mappoints + two keyframes (reference at identity,
    current at the recovered pose), all-pairs deformation graph with sigma =
    3 x the scaled depth std, KLT reference on the current image."""
    P = config.max_points
    ok = result.point_ok
    depths = result.landmarks[:, 2]
    scale = 3.0 / stats.masked_median(depths, ok)
    sigma_scaled = stats.masked_sigma(depths, ok) * scale

    _, sel = state_mod.top_k_stable(ok.to(torch.float32), P)
    sel_ok = ok[sel]
    track_id = torch.where(sel_ok, result.track_id[sel],
                           torch.full_like(result.track_id[sel], -1))
    zero2 = torch.zeros_like(result.cur_keypoints[sel])
    state = state._replace(
        slot_used=sel_ok,
        track_id=track_id,
        has_3d=sel_ok,
        positions=torch.where(sel_ok[:, None], result.landmarks[sel] * scale,
                              torch.zeros_like(result.landmarks[sel])),
        keypoints=torch.where(sel_ok[:, None], result.cur_keypoints[sel],
                              zero2),
        status=torch.where(sel_ok, klt.TRACKED_WITH_3D,
                           state_mod.NOT_IN_FRAME).to(torch.int32),
        scale=scale,
        next_track_id=torch.max(track_id) + 1,
    )

    # Reference keyframe (identity pose, reference keypoints), then the
    # current one.
    ref_view = state._replace(
        Tcw=se3.identity(device=sel.device),
        keypoints=torch.where(sel_ok[:, None], result.ref_keypoints[sel],
                              zero2))
    Tcw = se3.SE3(result.Tcw.q, result.Tcw.t * scale)
    state = state_mod.insert_keyframe(ref_view)._replace(
        Tcw=Tcw, keypoints=state.keypoints)
    state = state_mod.insert_keyframe(state)

    state = state._replace(graph=graph_mod.initialize(
        state.graph, state.positions, sel_ok,
        torch.clamp(3.0 * sigma_scaled, min=1e-3)))
    refs = klt.set_reference(pyramid, state.keypoints, sel_ok,
                             config.klt_config)
    return state_mod.insert_temporal_snapshot(state._replace(refs=refs))


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


def ransac_draws(config: init_mod.InitializerConfig, seed: int, count: int,
                 device):
    """The RANSAC draws (perm [F], gumbel [H, F]) of init attempt ``count``
    from a CPU ``torch.Generator`` seeded from (``seed``, ``count``), moved
    to ``device``: every device gets the same samples."""
    g = torch.Generator(device="cpu").manual_seed((seed << 32) | count)
    perm = torch.randperm(config.max_features, generator=g)
    u = torch.rand((config.n_hypotheses, config.max_features), generator=g)
    gumbel = -torch.log(-torch.log(
        torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return perm.to(device), gumbel.to(device)


class System:
    """Host sequencing over eager frames: the port's ``System.track_image``
    with ``frame_step`` for every steady frame."""

    def __init__(self, cam: cameras.Camera, config: Config = Config(),
                 init_config: Optional[init_mod.InitializerConfig] = None,
                 seed: int = 4, auto_reinitialize: bool = False):
        self.cam = cam
        self.device = cam.params.device
        self.config = config
        self.init_config = init_config or init_mod.InitializerConfig(
            rad_per_pixel=config.rad_per_pixel,
            nms_radius=config.nms_radius,
            klt_min_ssim=config.klt_min_ssim_init)
        self.auto_reinitialize = auto_reinitialize
        self.seed = seed
        self.status = NOT_INITIALIZED
        self.state = None
        self.init_state = None
        self._init_count = 0
        self._frames_since_kf = 0
        self._image_shape = None

    def _preprocess(self, img):
        img = torch.as_tensor(img, device=self.device)
        if img.dim() == 3:
            img = image_ops.rgb_to_gray(img)
        return img.to(torch.float32)

    def track_image(self, img) -> dict:
        gray = self._preprocess(img)
        if self._image_shape is None:
            self._image_shape = tuple(gray.shape)
        mask = torch.ones(gray.shape, dtype=torch.bool, device=self.device)
        if self.status == NOT_INITIALIZED:
            pyramid = klt.build_pyramid(gray, self.config.klt_config)
            self._initialize(pyramid, mask)
            return {"status": self.status}
        make_kf = self._frames_since_kf >= self.config.keyframe_every
        self._frames_since_kf = 0 if make_kf else self._frames_since_kf + 1
        self.state, result = frame_step(self.state, gray, mask, self.cam,
                                        self.config, make_kf)
        if bool(result.lost):
            if self.auto_reinitialize:
                self.status = NOT_INITIALIZED
                self.state = None
                self.init_state = None
            else:
                self.status = LOST
        return {"status": self.status, "n_tracked_3d": result.n_tracked_3d,
                "keyframe": make_kf}

    def _initialize(self, pyramid, mask):
        cfg = self.init_config
        kcfg = self.config.klt_config
        if self.init_state is None:
            self.init_state = init_mod.reset(pyramid, mask, 0, kcfg, cfg)
            self._init_count = 0
            return
        perm, gumbel = ransac_draws(cfg, self.seed, self._init_count,
                                    self.device)
        self.init_state, result = init_mod.init_step(
            self.init_state, pyramid, mask, perm, gumbel, self.cam, kcfg,
            cfg)
        self._init_count += 1
        if bool(result.success):
            state = state_mod.empty_state(self.config, self._image_shape,
                                          self.device)
            self.state = bootstrap_map(state, result, pyramid, self.config)
            self.status = TRACKING
            self.init_state = None
            self._frames_since_kf = 0
