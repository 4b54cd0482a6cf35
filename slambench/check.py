"""Whether a run is correct: what the timed path produced, held to the
plain reference (``slambench/reference``), which works out its own state
from the same frames, the same camera and configuration (built from the
configuration's file, not taken from the program) and the same RANSAC
draws.

What is compared, once the window has closed:

- steps: a sample of the window's steady frames, drawn from the seed. The
  reference steps its eager ``frame_step`` from the state the program's
  frame started from (the program's own state, converted leaf by leaf)
  on the same image and keyframe flag, and its new state is held to the
  program's: the camera pose, every slot's status and the map points.
  Where the program's frame latched LOST (the system then drops its map)
  only the LOST flag is compared.
- inits: the program's initialisations (the first, in set-up, from frame
  0; in a re-initialising cell a sample of the window's re-inits, each
  from the frame after the LOST latch). The reference's own System runs
  from the same frame until it is TRACKING; the success frame has to be
  the same, and the bootstrapped map is held to the program's. Then the
  reference's System steps once more, from its own state, on the frame
  after the success, and its state is held to the program's after that
  frame: one step that owes nothing to the program's state.

The reference is the port's eager algorithm written again in plain
torch, so a fault of the algorithm that both share (PERF.md) passes;
what the check sees is the timed path (the replayed graph, the kernels,
the host's sequencing) departing from that algorithm.

The numbers (a cell compares those that its limits file,
``slambench/limits/<cell>.json``, gives a limit; the others are printed
as readings): ``map_gap``, the largest over the compared states of the
95th percentile of the map points' position gaps (slots with a 3D point
on both sides); ``map_gap_max``, the largest single point's gap, which
sees a few bad points that the percentile passes; ``pose_gap``, the
largest camera pose gap (quaternion distance, sign aligned, or
translation distance in map units, whichever is larger);
``boot_map_gap_max`` and ``boot_pose_gap``, the same two over the inits'
states alone (each bootstrapped map and the state after the frame that
followed it), where the reference owes nothing to the program's state;
all five infinite where a LOST flag or a success frame differs, since
then no state can be held to the other; ``status_mismatch``, the largest
share of used slots whose status differs; ``init_frame_gap``;
``lost_mismatch``. Only numbers that the control (the reference in TF32
in the program's place) separates from sound runs get a limit (PERF.md).
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import NamedTuple, Optional

import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
NUMBERS = ("boot_map_gap_max", "boot_pose_gap", "map_gap", "map_gap_max",
           "pose_gap", "status_mismatch", "init_frame_gap", "lost_mismatch")
# What the inits' numbers take from each state's gaps.
BOOT = {"boot_map_gap_max": "map_gap_max", "boot_pose_gap": "pose_gap"}


def load_limits(cell: str) -> dict:
    path = LIMITS_DIR / f"{cell}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no limits for cell {cell!r} ({path})")
    limits = json.loads(path.read_text())["limits"]
    if not limits or set(limits) - set(NUMBERS):
        raise ValueError(f"{path}: limits {sorted(limits)} not among "
                         f"{NUMBERS}")
    return limits


class Step(NamedTuple):
    f: int
    before: object       # the program's state the frame started from
    after: object        # its state after the frame (None: LOST latched)
    keyframe: bool
    lost: bool


class Init(NamedTuple):
    f_reset: int         # the first frame the initialiser saw
    f_success: int       # the frame that returned TRACKING
    state: object        # the program's state right after it
    next_state: object = None  # after the frame that followed (None: LOST)
    next_lost: Optional[bool] = None  # None: that frame was not seen


class Sampler:
    """What the window keeps for the check, chosen from the seed by
    reservoir sampling as frames go by: ``k_steps`` steady frames,
    ``k_inits`` re-initialisations, ``k_lost`` frames that latched LOST.
    ``observe`` is ``window.one_frame``'s hook; it only keeps references
    to states the program made anyway (a step returns a fresh snapshot)."""

    def __init__(self, system, seed: int, k_steps: int, k_inits: int,
                 k_lost: int):
        self.system = system
        self.rng = random.Random(seed)
        self.k = {"steps": k_steps, "inits": k_inits, "lost": k_lost}
        self.seen = {"steps": 0, "inits": 0, "lost": 0}
        self.kept = {"steps": [], "inits": [], "lost": []}
        self.first_init: Optional[Init] = None
        self._reset_at = 0
        self._next = {}          # f_success -> (state, lost) of the frame after
        self.active = False

    def _offer(self, kind: str, item) -> None:
        self.seen[kind] += 1
        kept, k = self.kept[kind], self.k[kind]
        if len(kept) < k:
            kept.append(item)
            return
        j = self.rng.randrange(self.seen[kind])
        if j < k:
            kept[j] = item

    def observe(self, f: int, before, out) -> None:
        status = out["status"]
        if before is None:                       # an init frame
            if status == "TRACKING":
                init = Init(self._reset_at, f, self.system.state)
                if self.first_init is None:
                    self.first_init = init
                elif self.active:
                    self._offer("inits", init)
            return
        lost = status != "TRACKING"
        if lost:
            self._reset_at = f + 1
        if f - 1 not in self._next and self._wants_next(f - 1):
            self._next[f - 1] = (self.system.state, lost)
        if not self.active:
            return
        # With auto_reinitialize a latched frame leaves no state (None).
        self._offer("lost" if lost else "steps",
                    Step(f, before, self.system.state,
                         bool(out.get("keyframe", False)), lost))

    def _wants_next(self, f_success: int) -> bool:
        first = self.first_init
        return ((first is not None and first.f_success == f_success)
                or any(it.f_success == f_success
                       for it in self.kept["inits"]))

    def samples(self):
        inits = ([self.first_init] if self.first_init else []) \
            + self.kept["inits"]
        out = []
        for it in inits:
            if it.f_success in self._next:
                st, lost = self._next[it.f_success]
                it = it._replace(next_state=st, next_lost=lost)
            out.append(it)
        return self.kept["steps"] + self.kept["lost"], out


# --- the reference's side ------------------------------------------------


def _ref_classes():
    from slambench.reference.geometry import se3
    from slambench.reference.ops import klt
    from slambench.reference.slam import graph, state
    return {"SlamState": state.SlamState, "SE3": se3.SE3,
            "KLTRefs": klt.KLTRefs, "GraphState": graph.GraphState}


def to_reference(x, classes=None):
    """A program state tree as the reference's NamedTuples, every tensor
    cloned."""
    classes = classes or _ref_classes()
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):
        cls = classes[type(x).__name__]
        return cls(*(to_reference(getattr(x, f), classes)
                     for f in cls._fields))
    return x


def reference_setup(cfg: dict, device):
    """The reference's camera, Config and InitializerConfig, built from
    the configuration's file."""
    from slambench.reference.geometry import cameras
    from slambench.reference.slam import initializer
    from slambench.reference.slam.state import Config

    c = cfg["camera"]
    if c["model"] == "PinHole":
        cam = cameras.pinhole(c["fx"], c["fy"], c["cx"], c["cy"],
                              device=device)
    else:
        cam = cameras.kannala_brandt8(c["fx"], c["fy"], c["cx"], c["cy"],
                                      c["k0"], c["k1"], c["k2"], c["k3"],
                                      device=device)
    config = Config(**cfg["Config"])
    icfg = initializer.InitializerConfig(**{
        "rad_per_pixel": config.rad_per_pixel,
        "nms_radius": config.nms_radius,
        "klt_min_ssim": config.klt_min_ssim_init,
        **cfg.get("InitializerConfig", {})})
    return cam, config, icfg


class Outputs(NamedTuple):
    steps: list      # (state or None, lost) per step
    inits: list      # (success frame or None, state or None) per init
    nexts: list      # (state or None, lost or None) per init: the frame after


def run_reference(steps, inits, stream, cfg: dict, device,
                  tf32: bool = False, max_init_frames: int = 40) -> Outputs:
    """The reference's outputs on the sampled steps and inits; with
    ``tf32`` the same in TF32 (the control)."""
    from slambench.reference.slam import system as ref_system

    cam, config, icfg = reference_setup(cfg, device)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        out_steps = []
        for s in steps:
            gray = torch.as_tensor(stream.frame(s.f), device=device).to(
                torch.float32)
            mask = torch.ones(gray.shape, dtype=torch.bool, device=device)
            new, res = ref_system.frame_step(to_reference(s.before), gray,
                                             mask, cam, config, s.keyframe)
            out_steps.append((new, bool(res.lost)))
        out_inits, out_nexts = [], []
        for it in inits:
            sysm = ref_system.System(cam, config, icfg,
                                     seed=cfg["System"].get("seed", 4),
                                     auto_reinitialize=cfg["System"].get(
                                         "auto_reinitialize", False))
            success, state, nxt = None, None, (None, None)
            for f in range(it.f_reset, it.f_reset + max_init_frames):
                sysm.track_image(stream.frame(f))
                if sysm.status == ref_system.TRACKING:
                    success, state = f, sysm.state
                    break
            if success is not None and it.next_lost is not None:
                out = sysm.track_image(stream.frame(success + 1))
                lost = out["status"] != ref_system.TRACKING
                nxt = (None if lost else sysm.state, lost)
            out_inits.append((success, state))
            out_nexts.append(nxt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return Outputs(out_steps, out_inits, out_nexts)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def program_outputs(steps, inits) -> Outputs:
    return Outputs([(s.after, s.lost) for s in steps],
                   [(it.f_success, it.state) for it in inits],
                   [(None if it.next_lost else it.next_state, it.next_lost)
                    for it in inits])


# --- the comparison ------------------------------------------------------


def _quat_gap(qa, qb) -> float:
    return min(float(torch.linalg.norm(qa - qb)),
               float(torch.linalg.norm(qa + qb)))


def state_gaps(a, b) -> dict:
    """pose, map and status gaps between two states (any device)."""
    dev = b.positions.device
    qa, ta = a.Tcw.q.to(dev), a.Tcw.t.to(dev)
    pose = max(_quat_gap(qa, b.Tcw.q),
               float(torch.linalg.norm(ta - b.Tcw.t)))
    both = (a.slot_used.to(dev) & a.has_3d.to(dev) & b.slot_used
            & b.has_3d)
    gaps = torch.linalg.norm(a.positions.to(dev) - b.positions, dim=-1)[both]
    mp = float(torch.quantile(gaps, 0.95)) if gaps.numel() else 0.0
    mx = float(gaps.max()) if gaps.numel() else 0.0
    used = a.slot_used.to(dev) | b.slot_used
    differ = (a.status.to(dev) != b.status) & used
    share = float(differ.sum()) / max(int(used.sum()), 1)
    return {"pose_gap": pose, "map_gap": mp, "map_gap_max": mx,
            "status_mismatch": share}


def compare(got: Outputs, ref: Outputs) -> dict:
    """The numbers of ``got`` (the program's outputs, or the control's)
    against the reference's."""
    nums = dict.fromkeys(NUMBERS, 0.0)
    nums["compared"], nums["by_state"], broken = 0, [], False

    def take(label, g):
        for k, v in g.items():
            nums[k] = max(nums[k], v)
        if not label.startswith("step"):
            for k, v in BOOT.items():
                nums[k] = max(nums[k], g[v])
        nums["compared"] += 1
        nums["by_state"].append((label, g["map_gap_max"], g["pose_gap"]))

    for k, ((sa, la), (sb, lb)) in enumerate(zip(got.steps, ref.steps)):
        if la != lb:
            nums["lost_mismatch"] += 1
            broken = True
        elif sa is not None:
            take(f"step {k}", state_gaps(sa, sb))
    for k, ((fa, sa), (fb, sb)) in enumerate(zip(got.inits, ref.inits)):
        gap = float("inf") if fb is None or fa is None else abs(fa - fb)
        nums["init_frame_gap"] = max(nums["init_frame_gap"], gap)
        if gap == 0:
            take(f"init {k}", state_gaps(sa, sb))
        else:
            broken = True
    for k, ((sa, la), (sb, lb)) in enumerate(zip(got.nexts, ref.nexts)):
        if la is None or lb is None:
            continue
        if la != lb:
            nums["lost_mismatch"] += 1
            broken = True
        elif sa is not None:
            take(f"after init {k}", state_gaps(sa, sb))
    if broken:
        for k in ("pose_gap", "map_gap", "map_gap_max", *BOOT):
            nums[k] = float("inf")
    return nums


def verdict(nums: dict, limits: dict) -> bool:
    """Correct: something was compared, and every number with a limit is
    within it."""
    return nums["compared"] > 0 and all(nums[n] <= lim
                                        for n, lim in limits.items())
