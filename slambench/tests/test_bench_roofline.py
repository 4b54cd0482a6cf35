"""The kernels' yardstick counts from shapes and the schedule alone."""

import math

from slambench import roofline


def test_joint_and_ba_counts_follow_shapes_and_schedule():
    P, E = 768, 5000
    f = roofline.joint_flops(P, E)
    assert f == 200 * (140 * P + 24 * E) + 22 * (220 * P + 70 * E) \
        + 20 * 70 * P
    assert roofline.joint_flops(2 * P, 2 * E) == 2 * f
    K = 5
    b = roofline.ba_flops(K, P, E)
    assert b == 80 * (105 * K * P + 36 * K * E) \
        + 6 * (220 * K * P + 70 * K * E) + 5 * 70 * K * P
    # the schedule, not what a kernel reports, sets the work
    assert roofline.JOINT_SCHEDULE == {"lm_steps": 20, "cg_trips": 200,
                                       "linearizations": 22}
    assert roofline.BA_SCHEDULE == {"lm_steps": 5, "cg_trips": 80,
                                    "linearizations": 6}


def test_bound_is_the_larger_of_operations_and_bytes():
    pk = roofline.peak("NVIDIA H100 80GB HBM3")
    assert pk == {"flops": 67e12, "bytes": 3.35e12}
    assert math.isclose(roofline.bound_ms(67e9, 0, pk), 1.0)
    assert math.isclose(roofline.bound_ms(0, 3.35e9, pk), 1.0)
    P, E = 768, 5000
    fl, by = roofline.joint_flops(P, E), roofline.joint_bytes(P, E)
    assert fl / pk["flops"] > by / pk["bytes"]   # operations bound it
    assert roofline.joint_bytes(P, E) == roofline.joint_bytes(P, E)
    assert roofline.ba_bytes(5, P, E) > roofline.joint_bytes(P, E)
