"""kernels.joint_roofline: the joint pose + deformation kernel
(csrc/pose_deformation.cu) in the replayed frames: 100 x the summed bound
of its calls (slambench/roofline.py, from P, the frame's live edges and
the reference schedule) over their summed device time."""

from slambench import roofline


def read(rec):
    bound = ms = 0.0
    for r in rec["profiled"]:
        if not r["joint_ms"] or "E_joint" not in r:
            continue
        for call_ms in r["joint_ms"]:
            bound += roofline.bound_ms(
                roofline.joint_flops(rec["P"], r["E_joint"]),
                roofline.joint_bytes(rec["P"], r["E_joint"]), rec["peak"])
            ms += call_ms
    return 100.0 * bound / ms if ms > 0 else None
