"""The yardstick of the kernels' roofline shares: the card's peaks, and the
operations and bytes that the joint pose + deformation solve and the
keyframe bundle adjustment need, counted from their shapes and from the
reference schedule, not from the work a kernel reports doing.

Schedule (the plain drivers of ``slambench/reference/solver``): the joint
runs 2 rounds of 10 LM steps, each step a 10-trip PCG and one
linearisation, plus one linearisation to start each round; the BA runs 5
LM steps of a 16-trip PCG (the port's ``Config.ba_cg_iters``), each with a
linearisation, plus one to start. Per-item operation counts are those of
``chip_smoke.py``'s ``joint_flops`` / ``ba_flops``; each edge term is
counted once, although the kernels form it at both endpoints.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3 bandwidth.
PEAKS = {"NVIDIA H100 80GB HBM3": {"flops": 67e12, "bytes": 3.35e12}}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]

JOINT_SCHEDULE = {"lm_steps": 20, "cg_trips": 200, "linearizations": 22}
BA_SCHEDULE = {"lm_steps": 5, "cg_trips": 80, "linearizations": 6}

F32, I32, B8 = 4, 4, 1


def peak(device_name: str) -> dict:
    """The peaks of the named card (an H100 SXM's where it is not listed)."""
    return PEAKS.get(device_name, DEFAULT_PEAK)


def joint_flops(P: int, E_live: int, work=JOINT_SCHEDULE) -> float:
    """Per CG trip ~140 per point and ~24 per live edge; per linearisation
    ~220 per point and ~70 per live edge; per LM step ~70 per point."""
    return (work["cg_trips"] * (140 * P + 24 * E_live)
            + work["linearizations"] * (220 * P + 70 * E_live)
            + work["lm_steps"] * 70 * P)


def ba_flops(K: int, P: int, E_live: int, work=BA_SCHEDULE) -> float:
    """As ``joint_flops`` per landmark copy (K P) and per (keyframe, live
    edge): ~105 per copy and ~36 per (keyframe, live edge) a trip."""
    return (work["cg_trips"] * (105 * K * P + 36 * K * E_live)
            + work["linearizations"] * (220 * K * P + 70 * K * E_live)
            + work["lm_steps"] * 70 * K * P)


def joint_bytes(P: int, E_live: int) -> int:
    """Inputs read once (camera, seed pose, rest positions, observations,
    point mask; each live edge's i, j, weight, rest distance) and outputs
    written once (pose, flows, per-point chi2)."""
    return (8 * F32 + 7 * F32 + P * (3 * F32 + 2 * F32 + B8)
            + E_live * (2 * I32 + 2 * F32)
            + 7 * F32 + P * (3 * F32 + F32))


def ba_bytes(K: int, P: int, E_live: int) -> int:
    """Inputs read once (camera, K poses, K P landmark seeds, observations
    and their masks; each live edge's i, j, weight, rest distance) and
    outputs written once (K poses, K P landmarks)."""
    return (8 * F32 + K * 7 * F32 + K * P * (3 * F32 + 2 * F32 + B8)
            + E_live * (2 * I32 + 2 * F32)
            + K * 7 * F32 + K * P * 3 * F32)


def bound_ms(flops: float, nbytes: float, pk=DEFAULT_PEAK) -> float:
    """The least time the card could take: the larger of operations over
    the float32 peak and bytes over the memory bandwidth, in ms."""
    return 1e3 * max(flops / pk["flops"], nbytes / pk["bytes"])
