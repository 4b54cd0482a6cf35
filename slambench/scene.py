"""The benchmark's one traffic generator: a procedural deforming surface
seen by a camera that sweeps in and out over it on a closed path, rendered
once in set-up into a loop of ``loop_frames`` uint8 frames that repeats
without a seam, plus the blackout schedule that hides some frames.

The surface, its relief and its texture are those of the port's synthetic
scene (``nrslam_tpu_torch/datasets/synthetic.py``), written again here in
plain torch with the reference's geometry. What differs is time: the
camera path and the deformation phase are periodic in the frame index with
period ``loop_frames``, so frame ``loop_frames`` is frame 0 in pose and in
deformation, and a stream of any length walks the loop again and again.

A traffic mix is a JSON file of parameters under ``slambench/traffic/``
(see ``Mix``). The scene is the mix's alone; ``--seed`` draws only the
loop frame the stream starts on (``start_frame``): a whole number of
blackout cycles, so every seed meets the same loop with its blackouts at
the same loop frames, the same work in another order.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from slambench.reference.geometry import cameras, se3

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

# The deformation's phase advances by this many radians over one loop: the
# surface's phase multiples (1, 0.7, 1.3) all turn a whole number of times.
DEFORM_TURNS = 20.0 * math.pi


class Mix(NamedTuple):
    """A traffic mix's parameters (the JSON file's keys)."""

    loop_frames: int            # frames in the rendered loop (its period)
    speed: float                # path speed at its fastest, world units a frame
    depth_swing: float          # in-and-out amplitude of the camera's depth
    rotation: float             # amplitude of the camera's wobble, radians
    base_depth: float = 3.0
    relief: float = 1.0
    deform_amp: float = 0.02
    texture_scale: float = 3.0
    visible: int = 0            # frames seen between blackouts (0: none)
    blackout: int = 0           # black frames after each visible stretch
    why: str = ""


def load_mix(name: str) -> Mix:
    """The mix ``slambench/traffic/<name>.json``; its loop holds a whole
    number of blackout cycles."""
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    data = json.loads(path.read_text())
    mix = Mix(**{k: data[k] for k in Mix._fields if k in data})
    if mix.loop_frames % cycle(mix):
        raise ValueError(f"{path}: loop_frames {mix.loop_frames} is no "
                         f"whole number of {cycle(mix)}-frame cycles")
    return mix


def cycle(mix: Mix) -> int:
    """Frames of one blackout cycle (1 in a mix with no blackout)."""
    return mix.visible + mix.blackout if mix.blackout > 0 else 1


def start_frame(mix: Mix, seed: int) -> int:
    """The loop frame the seed's stream starts on: uniform among the
    starts of the loop's cycles. Any whole number seeds it (numpy's
    ``SeedSequence`` takes integers of any size)."""
    rng = np.random.default_rng(np.random.SeedSequence(abs(int(seed))))
    c = cycle(mix)
    return c * int(rng.integers(mix.loop_frames // c))


def is_black(mix: Mix, frame: int) -> bool:
    """Whether stream frame ``frame`` falls in a blackout: each cycle is
    ``visible`` frames seen, then ``blackout`` black ones; the scene clock
    runs on through the blackout."""
    return mix.blackout > 0 and frame % cycle(mix) >= mix.visible


def _surface(x, y, phase, mix: Mix):
    static = (mix.base_depth
              + mix.relief * (torch.sin(1.3 * x) * torch.cos(1.1 * y)
                              + 0.5 * torch.sin(2.9 * x + 1.7 * y)))
    deform = mix.deform_amp * (
        torch.sin(1.9 * x + phase) * torch.cos(1.4 * y + 0.7 * phase)
        + 0.6 * torch.sin(0.9 * y + 1.3 * phase))
    return static + deform


def _texture(x, y, mix: Mix):
    s = mix.texture_scale
    v = (torch.sin(s * 3.1 * x) * torch.cos(s * 2.7 * y)
         + 0.7 * torch.sin(s * 7.3 * x + s * 5.1 * y)
         + 0.5 * torch.cos(s * 11.7 * x - s * 8.3 * y)
         + 0.35 * torch.sin(s * 17.9 * x + s * 13.1 * y)
         + 0.25 * torch.cos(s * 29.0 * x + s * 23.0 * y))
    return 128.0 + 45.0 * v


def path_radius(mix: Mix) -> float:
    """The lateral amplitude A whose fastest point moves ``speed`` a frame:
    the path (A sin a, 0.35 A sin 2a) is fastest at a = 0, where it moves
    A (1 + 0.7^2)^0.5 2 pi / L a frame."""
    return mix.speed * mix.loop_frames / (2 * math.pi * math.hypot(1.0, 0.7))


def camera_pose(frame, mix: Mix, device) -> se3.SE3:
    """Tcw of loop frame ``frame``: the centre moves on a closed figure of
    eight over the surface while its height swings in and out, and the
    camera wobbles about its look direction (+z), all with period
    ``loop_frames``."""
    a = 2 * math.pi * frame / mix.loop_frames
    A = path_radius(mix)
    centre = torch.tensor([A * math.sin(a), 0.35 * A * math.sin(2 * a),
                           mix.depth_swing * math.sin(a + 1.0)],
                          dtype=torch.float32, device=device)
    r = mix.rotation
    rot = torch.tensor([r * math.sin(a + 0.5), r * math.cos(2 * a),
                        0.5 * r * math.sin(a)], dtype=torch.float32,
                       device=device)
    Rwc = se3.exp(torch.cat([rot, torch.zeros(3, device=device)]))
    return se3.inverse(se3.SE3(Rwc.q, centre))


def render(frame, cam: cameras.Camera, height: int, width: int, mix: Mix):
    """(gray [H, W] float32 in [0, 255], depth [H, W]) of loop frame
    ``frame`` on the camera's device: per pixel, eight fixed-point steps of
    the ray / surface intersection, as the port's synthetic scene does."""
    device = cam.params.device
    Twc = se3.inverse(camera_pose(frame, mix, device))
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    uv = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    rays_cam = cameras.unproject(cam, uv)
    rays_world = se3.quat_rotate(Twc.q[None], rays_cam)
    origin = Twc.t
    phase = DEFORM_TURNS * frame / mix.loop_frames
    s = torch.full((height * width,), mix.base_depth, dtype=torch.float32,
                   device=device)
    for _ in range(8):
        p = origin[None] + s[:, None] * rays_world
        f = _surface(p[:, 0], p[:, 1], phase, mix)
        s = (f - origin[2]) / rays_world[:, 2]
    p = origin[None] + s[:, None] * rays_world
    gray = _texture(p[:, 0], p[:, 1], mix)
    depth = (s * rays_cam[:, 2]).reshape(height, width)
    return torch.clamp(gray, 0.0, 255.0).reshape(height, width), depth


def render_loop(cam: cameras.Camera, height: int, width: int,
                mix: Mix) -> np.ndarray:
    """The whole loop as uint8 frames ``[L, H, W]`` in host memory,
    rendered on the camera's device and rounded to the nearest level."""
    out = np.empty((mix.loop_frames, height, width), dtype=np.uint8)
    for i in range(mix.loop_frames):
        gray, _ = render(i, cam, height, width, mix)
        out[i] = torch.round(gray).to(torch.uint8).cpu().numpy()
    return out


class Stream:
    """Stream frame ``f`` of a mix: loop frame ``(f + start) % L``, or
    black; blackouts follow the stream's index."""

    def __init__(self, loop: np.ndarray, mix: Mix, start: int = 0):
        self.loop = loop
        self.mix = mix
        self.start = start
        self.black = np.zeros_like(loop[0])

    def is_black(self, f: int) -> bool:
        return is_black(self.mix, f)

    def frame(self, f: int) -> np.ndarray:
        if self.is_black(f):
            return self.black
        return self.loop[(f + self.start) % self.mix.loop_frames]
