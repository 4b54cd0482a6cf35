"""Timing of the mapping's triangulation on one GPU, split into its parts
(counterpart of the root ``profile_mapping.py``).

    python -m nrslam_tpu_torch.profile_mapping [--points 768 --height 480
        --width 640 --new-kp 256]

On the steady state of ``profile_stages.steady_state``: the whole
triangulation mapping step (``mapping_triangulate``), the candidate
selection and deformable-input assembly it starts with
(``mapping.assemble_triangulation_inputs``, ``input_assembly``), and the
batched deformable LM on those inputs with 0, 1, 5 and 10 LM iterations
(``deformable_triangulation.deformable_triangulate(..., n_iters=)``,
one kernel launch a call on the card, ``deformable_lm_{n}it``; the frame
runs 10). Each as
``profile_stages.measure`` gives it: ``chained_ms``, ``device_ms`` and
``kernels`` of one call. The card's name, power limit and SM clock come
first. Needs a CUDA device.
"""

from __future__ import annotations

import json

from nrslam_tpu_torch import profile_stages
from nrslam_tpu_torch.utils import profiler
from nrslam_tpu_torch.utils.device import resolve

LM_ITERS = (0, 1, 5, 10)
KEYS = ("mapping_triangulate", "input_assembly") + tuple(
    f"deformable_lm_{n}it" for n in LM_ITERS)


def mapping_calls(pb: profile_stages.Problem) -> dict:
    """Every part of ``KEYS`` as (fn, perturb) for ``chained_timeit``."""
    from nrslam_tpu_torch.slam import mapping
    from nrslam_tpu_torch.solver import deformable_triangulation as dt

    s, cam, config = pb.state, pb.cam, pb.config

    def moved(eps):
        return s._replace(positions=s.positions + eps)

    _, inputs_c, _, _, _, poses = mapping.assemble_triangulation_inputs(
        s, config)

    def lm(n):
        return lambda ins: dt.deformable_triangulate(
            cam, ins, poses, config.rad_per_pixel, n_iters=n)[0]

    calls = {
        "mapping_triangulate": (lambda st: mapping.do_mapping(
            st, cam, config, has_new_keyframe=False).positions, moved),
        "input_assembly": (lambda st: mapping.assemble_triangulation_inputs(
            st, config)[1].obs, moved),
    }
    for n in LM_ITERS:
        calls[f"deformable_lm_{n}it"] = (
            lm(n), lambda eps: inputs_c._replace(obs=inputs_c.obs + eps))
    assert tuple(calls) == KEYS
    return calls


def run(pb: profile_stages.Problem, n: int = 20, warmup: int = 2) -> dict:
    """``profile_stages.measure`` of each part of ``KEYS``."""
    calls = mapping_calls(pb)
    return {k: profile_stages.measure(*calls[k], n=n, warmup=warmup)
            for k in KEYS}


def main(argv=None):
    args = profile_stages.size_args(__doc__.splitlines()[0], argv)
    dev = resolve()
    print(profiler.gpu_header(), flush=True)
    pb = profile_stages.steady_state(args.points, args.height, args.width,
                                     args.new_kp, dev)
    print(json.dumps({"where": f"{args.width}x{args.height} "
                      f"P={args.points} new_kp={args.new_kp}",
                      "stages": run(pb)}, indent=1))


if __name__ == "__main__":
    main()
