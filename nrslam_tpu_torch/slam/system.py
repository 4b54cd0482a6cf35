"""System facade: the per-frame entry point wiring preprocessing, monocular
initialisation, map bootstrap, tracking and mapping (counterpart of
nrslam_tpu/slam/system.py; reference system.{h,cc}).

- ``System.track_image(img)``                    (system.cc:113-132)
- ``System.track_image_with_depth(img, depth)``  (system.cc:162-187), which
  also runs the depth-RMSE evaluator on tracked frames.
- ``System.track_image_with_stereo(left, right, bf)`` (system.cc:134-160),
  which evaluates tracked frames against NCC stereo depth.

One steady-state frame (``frame_step``) = pyramid + tracking + mapping, then
the LOST freeze: once the collapse latch is set, every later frame returns
the old state unchanged (the reference exits at the collapse frame,
tracking.cc:97-99). Steady frames read nothing back to the host except the
LOST flag every ``lost_check_every`` frames; init frames read their reset
and success flags once each.

On the card, ``System`` builds a ``frame_graph.FrameGraph`` (both frame
kinds captured as CUDA graphs) at its first steady frame and replays it for
every steady frame after, a re-initialised map included; on the CPU it
calls ``frame_step``. Likewise it builds an ``init_graph.InitGraphs`` (an
init frame's device work between its host reads, captured as CUDA graphs)
at its first init frame on the card and replays it for every init frame
after, every recovery included; on the CPU it calls the initializer's
``reset`` and ``init_step``.

While a tracer is on (``utils.profiler.tracing``), each ``track_image``
call is one frame record: its ``nrslam.`` spans, its kind, its counters
and, for a replayed frame, the device stage times its graph stamped
(read once after the frame's LOST read).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nrslam_tpu_torch.eval import evaluator as evaluator_mod
from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.ops import image as image_ops
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.ops import stereo as stereo_ops
from nrslam_tpu_torch.slam import graph as graph_mod
from nrslam_tpu_torch.slam import initializer as init_mod
from nrslam_tpu_torch.slam import mapping as mapping_mod
from nrslam_tpu_torch.slam import state as state_mod
from nrslam_tpu_torch.slam import tracking as tracking_mod
from nrslam_tpu_torch.slam.state import Config
from nrslam_tpu_torch.utils import profiler, stats, tree

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


def bootstrap_map_stereo(state, keypoints, landmarks, point_ok, track_ids,
                         pyramid, config: Config, graph_sigma: float = 10.5):
    """The initial map from stereo-triangulated landmarks
    (Tracking::StereoMapInitialization, tracking.cc:216-289): metric
    landmarks from a stereo matcher, scale 1, the stereo graph sigma 10.5
    and a single keyframe."""
    P = config.max_points
    _, sel = state_mod.top_k_stable(point_ok.to(torch.float32), P)
    sel_ok = point_ok[sel]
    track_id = torch.where(sel_ok, track_ids[sel],
                           torch.full_like(track_ids[sel], -1))
    state = state._replace(
        slot_used=sel_ok,
        track_id=track_id,
        has_3d=sel_ok,
        positions=torch.where(sel_ok[:, None], landmarks[sel],
                              torch.zeros_like(landmarks[sel])),
        keypoints=torch.where(sel_ok[:, None], keypoints[sel],
                              torch.zeros_like(keypoints[sel])),
        status=torch.where(sel_ok, klt.TRACKED_WITH_3D,
                           state_mod.NOT_IN_FRAME).to(torch.int32),
        scale=torch.ones((), dtype=torch.float32, device=sel.device),
        next_track_id=torch.max(track_id) + 1,
    )
    state = state._replace(graph=graph_mod.initialize(
        state.graph, state.positions, sel_ok, graph_sigma))
    refs = klt.set_reference(pyramid, state.keypoints, sel_ok,
                             config.klt_config)
    state = state_mod.insert_keyframe(state._replace(refs=refs))
    return state_mod.insert_temporal_snapshot(state)


def frame_step(state, gray, mask, cam: cameras.Camera, config: Config,
               make_keyframe: bool):
    """One steady-state SLAM frame (System::TrackImage after init).
    Returns (state, tracking.FrameResult)."""
    old = state
    profiler.stage("frame.pyramid")
    pyramid = klt.build_pyramid(gray, config.klt_config)
    state, result = tracking_mod.process_frame(state, pyramid, mask, cam,
                                               config, make_keyframe)
    state = mapping_mod.do_mapping(state, cam, config,
                                   has_new_keyframe=make_keyframe)
    profiler.stage("frame.writeback")
    state = tree.where(old.lost, old, state)
    result = result._replace(
        n_tracked_3d=torch.where(old.lost, torch.zeros_like(
            result.n_tracked_3d), result.n_tracked_3d),
        lost=old.lost | result.lost)
    profiler.device_count("map.slots_used", state.slot_used)
    profiler.device_count("map.slots_3d", state.slot_used & state.has_3d)
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
    """Stateful driver: host sequencing over device steps on the camera's
    device. RANSAC draws come from a CPU ``torch.Generator`` seeded from
    (``seed``, init frame count), so every device draws the same samples."""

    def __init__(self, cam: cameras.Camera, config: Config = Config(),
                 init_config: Optional[init_mod.InitializerConfig] = None,
                 masker=None, apply_clahe: bool = False, seed: int = 4,
                 auto_reinitialize: bool = False,
                 lost_check_every: int = 1,
                 init_check_every: int = 1):
        self.cam = cam
        self.device = cam.params.device
        self.config = config
        self.init_config = init_config or init_mod.InitializerConfig(
            rad_per_pixel=config.rad_per_pixel,
            nms_radius=config.nms_radius,
            klt_min_ssim=config.klt_min_ssim_init)
        self.masker = masker
        self.apply_clahe = apply_clahe
        self.auto_reinitialize = auto_reinitialize
        self.status = NOT_INITIALIZED
        self.state = None
        self.init_state = None
        self._frames_since_kf = 0
        # LOST is read on the host every N frames; the device latch freezes
        # the map in between, so only its surfacing is deferred.
        self.lost_check_every = max(1, int(lost_check_every))
        # Init success flags are checked in batches of N; the success
        # frame's own pyramid and result seed the map.
        self.init_check_every = max(1, int(init_check_every))
        self._init_ring = []
        self._init_count = 0
        self._frame_count = 0
        self.seed = seed  # the reference fixes srand(4)
        self.evaluator = evaluator_mod.FrameEvaluator()
        self._image_shape = None
        self._ones_mask = None
        # The captured frame (frame_graph.FrameGraph) and the captured init
        # (init_graph.InitGraphs), on the card only.
        self.frame_graph = None
        self.init_graphs = None

    # -- preprocessing ------------------------------------------------------

    def _preprocess(self, img):
        img = torch.as_tensor(img, device=self.device)
        if img.dim() == 3:
            img = image_ops.rgb_to_gray(img)
        img = img.to(torch.float32)
        if self.apply_clahe:
            img = image_ops.clahe(img)
        return img

    def _mask(self, gray):
        if self.masker is None:
            if self._ones_mask is None or self._ones_mask.shape != gray.shape:
                self._ones_mask = torch.ones(gray.shape, dtype=torch.bool,
                                             device=self.device)
            return self._ones_mask
        return self.masker(gray)

    def _draws(self, count: int):
        """(perm [F], gumbel [H, F]) of init attempt ``count``."""
        return ransac_draws(self.init_config, self.seed, count, self.device)

    # -- main entry points --------------------------------------------------

    def track_image(self, img) -> dict:
        with profiler.span(profiler.FRAME):
            return self._track_image(img)

    def _track_image(self, img) -> dict:
        with profiler.span("nrslam.system.preprocess"):
            gray = self._preprocess(img)
        if self._image_shape is None:
            self._image_shape = tuple(gray.shape)
        with profiler.span("nrslam.system.mask"):
            mask = self._mask(gray)

        if self.status == NOT_INITIALIZED:
            profiler.note(kind="init")
            with profiler.span("nrslam.system.init"):
                self._initialize(gray, mask)
            return {"status": self.status}

        make_kf = self._frames_since_kf >= self.config.keyframe_every
        self._frames_since_kf = 0 if make_kf else self._frames_since_kf + 1
        profiler.note(kind="kf" if make_kf else "nonkf")
        if self.device.type == "cuda":
            if self.frame_graph is None:
                from nrslam_tpu_torch.slam import frame_graph
                with profiler.span("nrslam.system.frame_graph_build"):
                    self.frame_graph = frame_graph.FrameGraph(
                        self.state, gray, mask, self.cam, self.config)
            with profiler.span("nrslam.system.replay"):
                self.state, frame_result = self.frame_graph.step(
                    self.state, gray, mask, make_kf)
        else:
            with profiler.span("nrslam.system.frame_step"):
                self.state, frame_result = frame_step(
                    self.state, gray, mask, self.cam, self.config, make_kf)
        self._frame_count += 1

        lost = False
        if self._frame_count % self.lost_check_every == 0:
            with profiler.span("nrslam.system.lost_read"):
                lost = bool(frame_result.lost)
        if self.frame_graph is not None:
            with profiler.span("nrslam.system.stamps"):
                profiler.read_stamps(self.frame_graph.stamps[make_kf])
        if lost:
            if self.auto_reinitialize:
                self.status = NOT_INITIALIZED
                self.state = None
                self.init_state = None
            else:
                self.status = LOST
        return {"status": self.status,
                "n_tracked_3d": frame_result.n_tracked_3d,
                "keyframe": make_kf}

    def track_image_with_depth(self, img, depth) -> dict:
        out = self.track_image(img)
        if self.status == TRACKING and self.state is not None:
            out["depth_rmse"] = self.evaluator.evaluate(
                self.state, self.cam, torch.as_tensor(depth,
                                                      device=self.device))
        return out

    def track_image_with_stereo(self, img_left, img_right,
                                bf: float = 0.0) -> dict:
        """Track the left image; with ``bf`` > 0, evaluate a tracked frame
        against NCC stereo depth of its TRACKED_WITH_3D slots
        (system.cc:134-160, whose evaluator call the reference compiles
        out): ``stereo_rmse`` is the scale-aligned RMSE after the 1.5 IQR
        pre-filter over the 0.9 best inliers (frame_evaluator.cc:138-162),
        read back to the host."""
        out = self.track_image(img_left)
        if bf > 0 and self.status == TRACKING and self.state is not None:
            st = self.state
            valid = st.slot_used & (st.status == klt.TRACKED_WITH_3D)
            gt3d, ok = stereo_ops.stereo_pattern_matching(
                self.cam, bf, self._preprocess(img_left),
                self._preprocess(img_right), st.keypoints, valid)
            est = se3.apply(st.Tcw, st.positions)[..., 2]
            out["stereo_rmse"] = float(evaluator_mod._scale_aligned_rmse(
                est, gt3d[..., 2], ok, inlier_fraction=0.9,
                iqr_reject=True))
        return out

    # -- initialisation -----------------------------------------------------

    def _init_graphs(self, gray, mask):
        """The captured init, built at the first init frame on the card;
        None on the CPU."""
        if self.init_graphs is None and self.device.type == "cuda":
            from nrslam_tpu_torch.slam import init_graph
            with profiler.span("nrslam.system.init_graph_build"):
                self.init_graphs = init_graph.InitGraphs(
                    gray, mask, self.cam, self.config.klt_config,
                    self.init_config)
        return self.init_graphs

    def _initialize(self, gray, mask):
        cfg = self.init_config
        kcfg = self.config.klt_config
        graphs = self._init_graphs(gray, mask)
        if graphs is None:
            pyramid = klt.build_pyramid(gray, kcfg)
        else:
            pyramid = graphs.pyramid(gray, mask)
        if self.init_state is None:
            self.init_state = (init_mod.reset(pyramid, mask, 0, kcfg, cfg)
                               if graphs is None else graphs.reset())
            self._init_ring = []
            self._init_count = 0
            return

        perm, gumbel = self._draws(self._init_count)
        if graphs is None:
            self.init_state, result = init_mod.init_step(
                self.init_state, pyramid, mask, perm, gumbel, self.cam, kcfg,
                cfg)
        else:
            self.init_state, result, pyramid = graphs.step(self.init_state,
                                                           perm, gumbel)
        self._init_ring.append((result, pyramid))
        self._init_count += 1
        if self._init_count % self.init_check_every:
            return

        with profiler.span("nrslam.init.sync"):
            flags = torch.stack([r.success
                                 for r, _ in self._init_ring]).tolist()
        ring = self._init_ring
        self._init_ring = []
        for ok, (result, pyr) in zip(flags, ring):
            if ok:
                with profiler.span("nrslam.system.bootstrap_map"):
                    state = state_mod.empty_state(self.config,
                                                  self._image_shape,
                                                  self.device)
                    self.state = bootstrap_map(state, result, pyr,
                                               self.config)
                self.status = TRACKING
                self.init_state = None
                self._frames_since_kf = 0
                return

    # -- introspection ------------------------------------------------------

    def trajectory_pose(self):
        return None if self.state is None else self.state.Tcw

    def map_points(self):
        if self.state is None:
            return np.zeros((0, 3))
        used = (self.state.slot_used & self.state.has_3d).cpu().numpy()
        return self.state.positions.cpu().numpy()[used]
