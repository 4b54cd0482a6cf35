"""The measured window and the end-to-end arithmetic.

A frame's time runs from handing its uint8 image (host memory) to
``System.track_image`` until its camera pose (``trajectory_pose()``) is on
the host; a frame that has no pose yet (an init frame before success)
ends when the device has finished its work. Every frame of the window is
counted: the rate is all its frames over all its time, the tail is the
tail of all its frames.

The functions below ``drive`` take plain records and are what the CPU
tests hold.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import NamedTuple, Optional

import torch

TRACKING = "TRACKING"


class Frame(NamedTuple):
    """One frame handed to ``track_image``: its stream index, its kind
    (``init`` while the system was not initialised, else ``kf`` or
    ``nonkf`` by the returned ``keyframe`` flag), whether it was black,
    host-clock start and end (s), the status it returned, and whether it
    raised."""

    f: int
    kind: str
    black: bool
    t0: float
    t1: float
    status: str
    raised: bool = False

    @property
    def ms(self) -> float:
        return 1e3 * (self.t1 - self.t0)


def frame_done(system, device) -> None:
    """Wait until the frame's pose is on the host (or, with no pose yet,
    until the device has finished the frame)."""
    pose = system.trajectory_pose()
    if pose is None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return
    torch.cat((pose.q, pose.t)).cpu()


def one_frame(system, stream, f: int, device, observe=None) -> Frame:
    """Hand stream frame ``f`` to the system and wait for its pose.
    ``observe(f, before, out)``, if given, sees the state the frame started
    from and what it returned (after the pose is on the host)."""
    before = system.state
    was_init = system.status != TRACKING
    img = stream.frame(f)
    t0 = time.perf_counter()
    try:
        out = system.track_image(img)
        frame_done(system, device)
    except Exception:  # a frame that raises is a failed frame
        t1 = time.perf_counter()
        import traceback
        traceback.print_exc()
        return Frame(f, "init" if was_init else "nonkf", stream.is_black(f),
                     t0, t1, "RAISED", True)
    t1 = time.perf_counter()
    if was_init or "keyframe" not in out:
        kind = "init"
    else:
        kind = "kf" if out["keyframe"] else "nonkf"
    if observe is not None:
        observe(f, before, out)
    return Frame(f, kind, stream.is_black(f), t0, t1, out["status"])


def drive(system, stream, f0: int, seconds: float, device,
          observe=None) -> list:
    """Frames from stream index ``f0`` until ``seconds`` have passed since
    the first was handed over; the frame in flight at the close finishes
    and is counted."""
    frames = []
    start = time.perf_counter()
    f = f0
    while True:
        frames.append(one_frame(system, stream, f, device, observe))
        f += 1
        if frames[-1].t1 - start >= seconds:
            return frames


# --- end-to-end arithmetic ---------------------------------------------


def frames_per_s(frames) -> float:
    """Frames of the window over the window's seconds (first hand-over to
    last return)."""
    return len(frames) / (frames[-1].t1 - frames[0].t0)


def p95_ms(frames) -> float:
    """The 95th percentile of every frame's ms (``statistics.quantiles``,
    n=20, exclusive method)."""
    ms = [fr.ms for fr in frames]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=20)[-1]


class Stretch(NamedTuple):
    """A run of visible frames between blackouts, as window indices
    ``[lo, hi)``; ``ended`` when a black frame follows it in the window;
    ``lost_at_start`` when the system was not tracking as it began;
    ``recovered`` the window index of its first frame that returned
    TRACKING, if it began lost."""

    lo: int
    hi: int
    ended: bool
    lost_at_start: bool
    recovered: Optional[int]


def stretches(frames) -> list:
    """The visible stretches of a window with blackouts."""
    out = []
    i, n = 0, len(frames)
    while i < n:
        if frames[i].black:
            i += 1
            continue
        lo = i
        while i < n and not frames[i].black:
            i += 1
        lost = frames[lo].kind == "init"
        rec = None
        if lost:
            rec = next((j for j in range(lo, i)
                        if frames[j].status == TRACKING), None)
        out.append(Stretch(lo, i, i < n, lost, rec))
    return out


def recoveries_ms(frames) -> list:
    """ms of each recovery completed in the window: from handing the first
    visible frame after a blackout to the return of its stretch's first
    frame that is TRACKING again. A stretch that began before the window
    (the window's first frame) does not count."""
    out = []
    for s in stretches(frames):
        if s.lost_at_start and s.recovered is not None and s.lo > 0 \
                and frames[s.lo - 1].black:
            out.append(1e3 * (frames[s.recovered].t1 - frames[s.lo].t0))
    return out


def recovery_init_frames(frames) -> list:
    """Init frames of each recovery that ``recoveries_ms`` counts: those
    of the blackout before its stretch (from the one after the LOST latch)
    and those of the stretch up to and with its first TRACKING frame."""
    out = []
    for s in stretches(frames):
        if s.lost_at_start and s.recovered is not None and s.lo > 0 \
                and frames[s.lo - 1].black:
            j = s.lo
            while j > 0 and frames[j - 1].kind == "init":
                j -= 1
            out.append(s.recovered + 1 - j)
    return out


def recover_ms(frames) -> Optional[float]:
    """The sum of the window's recovery times over their count; None
    where none completed."""
    rec = recoveries_ms(frames)
    return math.fsum(rec) / len(rec) if rec else None


def failed(frames, relost: bool) -> int:
    """Frames that failed: every frame that raised; in a steady cell every
    frame that did not return TRACKING; in a re-initialising cell every
    frame of a visible stretch that ended (a blackout followed it in the
    window) without the system TRACKING at its last frame."""
    bad = {i for i, fr in enumerate(frames) if fr.raised}
    if not relost:
        bad |= {i for i, fr in enumerate(frames) if fr.status != TRACKING}
        return len(bad)
    for s in stretches(frames):
        if s.ended and frames[s.hi - 1].status != TRACKING:
            bad |= set(range(s.lo, s.hi))
    return len(bad)
