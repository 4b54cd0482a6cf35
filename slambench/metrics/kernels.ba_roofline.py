"""kernels.ba_roofline: the keyframe BA kernel (csrc/bundle_adjustment.cu)
in the replayed keyframes: 100 x the summed bound of its calls
(slambench/roofline.py, from the window's valid keyframes, P, the live
edges and the reference schedule) over their summed device time."""

from slambench import roofline


def read(rec):
    bound = ms = 0.0
    for r in rec["profiled"]:
        if not r["ba_ms"] or "E_ba" not in r:
            continue
        K, E = r["K_ba"], r["E_ba"]
        for call_ms in r["ba_ms"]:
            bound += roofline.bound_ms(
                roofline.ba_flops(K, rec["P"], E),
                roofline.ba_bytes(K, rec["P"], E), rec["peak"])
            ms += call_ms
    return 100.0 * bound / ms if ms > 0 else None
