"""The init frame captured as CUDA graphs between its host reads: the
device work of ``initializer.init_step`` (and of the first ``reset``) cut
where the host reads from the device or branches, one graph a segment.

Segments (``SEGMENTS``), in the order an init frame replays them:

- ``pyramid``: ``klt.build_pyramid`` of the frame, on every init frame;
- ``reset``: ``initializer.reset`` on that pyramid: on the first frame of
  a recovery, and after an attempt whose ``reset_needed`` is set;
- ``attempt_a``: ``track_frame`` (the KLT kernel), ``reset_needed``, the
  rays, the k-means, the stratified sample and its 8-point systems; then
  the host's ``_eight_point_host``;
- ``attempt_b``: the hypotheses scored, the best one and the refit's
  normal matrix; then the host's ``_refit_host``;
- ``attempt_c``: the refit E, kept or not; then the host's
  ``_decompose_host``;
- ``attempt_d``: the pose, the points, the success flag and the two flags
  the host reads (reset, success), read in one copy;
- ``refine``: ``_refine``'s three pose-only solves and re-triangulations,
  when the attempt succeeded.

``InitGraphs`` keeps every tensor that crosses a segment or a host
boundary in one packed buffer (``frame_graph.KindGraphs``, ``Buffers``):
the frame's pyramid, the ``InitializerState`` (its KLT references too),
the draws, the sample, what each host step returns, the reconstruction
and the flags, and the attempt's constants. Their shapes are fixed by
``max_features``, ``n_hypotheses`` and the image's. The captures share one
memory pool: every body writes its results into the buffer, and the
segments replay one at a time. ``System`` builds it at its first init
frame on the card and keeps it across recoveries. The eager
``initializer`` functions run the same pieces in the same order on any
device, so a replayed init frame gives what an eager one gives, bit for
bit.

Each launch is a span ``nrslam.init.<segment>``, tallies
``init_graph.replays.<segment>`` and adds the host tally its capture
recorded (``initializer.tracked_frames``, ``initializer.refines``, the KLT
and pose-only launches). The graph's nodes are counted at capture
(``nodes``) and tallied as ``init_graph.nodes.<segment>``.

CUDA tensors only; on a CPU tensor the constructor raises. A capture or a
replay that fails raises: nothing falls back to the eager init.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nrslam_tpu_torch.geometry import cameras, se3
from nrslam_tpu_torch.ops import klt
from nrslam_tpu_torch.slam import frame_graph
from nrslam_tpu_torch.slam import initializer as init_mod
from nrslam_tpu_torch.utils import profiler, tree

SEGMENTS = ("pyramid", "reset", "attempt_a", "attempt_b", "attempt_c",
            "attempt_d", "refine")


class Reconstruction(NamedTuple):
    """What ``attempt_d`` writes of the result and ``refine`` rewrites; the
    keypoints and track ids are the state's."""

    success: torch.Tensor     # bool, the reset flag folded in
    Tcw: se3.SE3
    landmarks: torch.Tensor   # [F, 3]
    point_ok: torch.Tensor    # [F]


class Buffers(NamedTuple):
    """Every tensor an init frame hands from a segment to the next or to
    and from the host."""

    state: init_mod.InitializerState
    pyramid: list             # [(image, gradients)] per level
    perm: torch.Tensor        # [F]
    gumbel: torch.Tensor      # [H, F]
    reset_needed: torch.Tensor
    sample: init_mod.Sample
    eight_point: tuple        # (u, vt) [H, 3, 3], from the host
    scored: init_mod.Scored
    refit: tuple              # (u, vt) [3, 3], from the host
    chosen: tuple             # (E [3, 3], inliers [F])
    decomposed: tuple         # (u, vt [3, 3], flip [2]), from the host
    recon: Reconstruction
    flags: torch.Tensor       # [2] bool: reset_needed, success
    c: init_mod.Constants


def buffers_like(gray, mask, cam: cameras.Camera, klt_config: klt.KLTConfig,
                 config: init_mod.InitializerConfig) -> Buffers:
    """Buffers shaped and laid out as an eager init frame on ``gray``
    hands its tensors over (``tree.packing`` keeps each layout, LAPACK's
    column-major results too): the eager pieces run once here, a reset on
    ``gray`` and an attempt of it against itself with zero draws, their
    host tally dropped."""
    dev = gray.device

    def run() -> Buffers:
        pyramid = klt.build_pyramid(gray, klt_config)
        state = init_mod.reset(pyramid, mask, 0, klt_config, config)
        perm = torch.zeros(config.max_features, dtype=torch.int64,
                           device=dev)
        gumbel = torch.zeros((config.n_hypotheses, config.max_features),
                             device=dev)
        state, reset_needed = init_mod._track(state, pyramid, klt_config,
                                              config)
        sample = init_mod._sample(cam, state, config, perm, gumbel)
        c = init_mod.constants(dev)
        eight_point = init_mod._on_host(init_mod._eight_point_host, sample.A)
        scored = init_mod._score(*eight_point, sample, config, c)
        refit = init_mod._on_host(init_mod._refit_host, scored.M)
        chosen = init_mod._choose(*refit, scored, sample, config, c)
        decomposed = init_mod._on_host(init_mod._decompose_host, chosen[0])
        r = init_mod._reconstruct(cam, *decomposed, state, sample, chosen[1],
                                  config, c)
        return Buffers(
            state=state, pyramid=pyramid, perm=perm, gumbel=gumbel,
            reset_needed=reset_needed, sample=sample,
            eight_point=eight_point, scored=scored, refit=refit,
            chosen=chosen, decomposed=decomposed,
            recon=Reconstruction(r.success, r.Tcw, r.landmarks, r.point_ok),
            flags=torch.stack([reset_needed, r.success]), c=c)

    return profiler.record(run)[0]


def result_of(v: Buffers) -> init_mod.InitializationResult:
    """The attempt's result as views into the buffers."""
    return init_mod.InitializationResult(
        success=v.recon.success, Tcw=v.recon.Tcw,
        ref_keypoints=v.state.ref_keypoints,
        cur_keypoints=v.state.cur_keypoints, landmarks=v.recon.landmarks,
        point_ok=v.recon.point_ok, track_id=v.state.track_id)


class InitGraphs(frame_graph.KindGraphs):
    """Each segment of an init frame captured over ``Buffers`` on the card.
    Built from the first init frame's ``gray`` and ``mask``, the camera and
    the configurations, which the graphs keep. ``pyramid``, ``reset`` and
    ``step`` are an init frame's calls; ``nodes[segment]`` the graph's
    nodes (``KindGraphs`` holds the other readings)."""

    kinds = SEGMENTS
    shared_pool = True

    def __init__(self, gray, mask, cam: cameras.Camera,
                 klt_config: klt.KLTConfig,
                 config: init_mod.InitializerConfig):
        self.cam, self.klt_config, self.config = cam, klt_config, config
        super().__init__(buffers_like(gray, mask, cam, klt_config, config),
                         gray, mask)

    def _check(self) -> None:
        for x in (self.buf, self.gray, self.mask, self.cam.params):
            if x.device.type != "cuda" or x.device != self.device:
                raise ValueError("InitGraphs: expected tensors on one CUDA "
                                 f"device, got {x.device} (the CPU runs the "
                                 "eager initializer)")

    def _build(self) -> None:
        super()._build()
        self.nodes = {seg: self.stamps[seg].nodes for seg in self.kinds}
        for seg, n in self.nodes.items():
            profiler.tally_max("init_graph.nodes." + seg, n)

    def _body(self, v: Buffers, seg: str) -> None:
        cam, kcfg, cfg = self.cam, self.klt_config, self.config
        if seg == "pyramid":
            tree.copy_(v.pyramid, klt.build_pyramid(self.gray, kcfg))
        elif seg == "reset":
            tree.copy_(v.state, init_mod._reset(
                v.pyramid, self.mask, v.state.next_track_id, kcfg, cfg))
        elif seg == "attempt_a":
            state, reset_needed = init_mod._track(v.state, v.pyramid, kcfg,
                                                  cfg)
            sample = init_mod._sample(cam, state, cfg, v.perm, v.gumbel)
            tree.copy_((v.state, v.reset_needed, v.sample),
                       (state, reset_needed, sample))
        elif seg == "attempt_b":
            tree.copy_(v.scored, init_mod._score(*v.eight_point, v.sample,
                                                 cfg, v.c))
        elif seg == "attempt_c":
            tree.copy_(v.chosen, init_mod._choose(*v.refit, v.scored,
                                                  v.sample, cfg, v.c))
        elif seg == "attempt_d":
            r = init_mod._reconstruct(cam, *v.decomposed, v.state, v.sample,
                                      v.chosen[1], cfg, v.c)
            tree.copy_((v.recon, v.flags), (
                Reconstruction(r.success & ~v.reset_needed, r.Tcw,
                               r.landmarks, r.point_ok),
                torch.stack([v.reset_needed, r.success])))
        elif seg == "refine":
            r = init_mod._refine(cam, result_of(v), v.chosen[1], cfg)
            tree.copy_(v.recon[1:], (r.Tcw, r.landmarks, r.point_ok))
        else:
            raise ValueError(f"InitGraphs: no segment {seg!r}")

    def _launch(self, seg: str) -> None:
        """Replay the graph of ``seg`` and add what its capture recorded."""
        with profiler.span("nrslam.init." + seg):
            self._graphs[seg].replay()
        self.replays += 1
        profiler.replay(self.recorded[seg])
        profiler.tally("init_graph.replays." + seg)

    def pyramid(self, gray, mask) -> list:
        """``klt.build_pyramid(gray)`` by replay, with ``gray`` and
        ``mask`` copied in for the frame's other segments. Returns the
        buffers' pyramid (views that the next frame overwrites)."""
        if gray.shape != self.gray.shape or mask.shape != self.mask.shape:
            raise ValueError(f"InitGraphs: frame {list(gray.shape)}, mask "
                             f"{list(mask.shape)}; captured for "
                             f"{list(self.gray.shape)}")
        self.gray.copy_(gray)
        self.mask.copy_(mask)
        self._launch("pyramid")
        return self.views.pyramid

    def reset(self) -> init_mod.InitializerState:
        """``initializer.reset(pyramid, mask, 0, ...)`` on this frame, by
        replay: a recovery's first state, the buffers' own (``step``
        advances it in place)."""
        self.views.state.next_track_id.zero_()
        self._launch("reset")
        return self.views.state

    def step(self, state: init_mod.InitializerState, perm, gumbel):
        """``initializer.init_step(state, pyramid, mask, perm, gumbel, cam,
        klt_config, config)`` on this frame, by replay; ``state`` is copied
        in unless it is the buffers' own. Returns (state, result, pyramid):
        the state is the buffers' own, which the next step advances in
        place; the result and the pyramid are copies that no later replay
        writes into."""
        v = self.views
        if state is not v.state:
            tree.copy_(v.state, state)
        v.perm.copy_(perm)
        v.gumbel.copy_(gumbel)
        self._launch("attempt_a")
        init_mod._on_host(init_mod._eight_point_host, v.sample.A,
                          out=v.eight_point)
        self._launch("attempt_b")
        init_mod._on_host(init_mod._refit_host, v.scored.M, out=v.refit)
        self._launch("attempt_c")
        init_mod._on_host(init_mod._decompose_host, v.chosen[0],
                          out=v.decomposed)
        self._launch("attempt_d")
        with profiler.span("nrslam.init.sync"):
            do_reset, success = v.flags.tolist()
        if success:
            self._launch("refine")
        # Copies before the reset rewrites the state the result points at.
        result, pyramid = tree.tree_map(torch.clone, (result_of(v),
                                                      v.pyramid))
        if do_reset:
            self._launch("reset")
        return v.state, result, pyramid
