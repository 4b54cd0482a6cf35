"""The row-sharded frame and the keyframe-sharded BA with one card per rank
on NCCL, each held to one process on card 0 under the gates of
``chip_smoke.py``'s ``[parallel]`` (which runs them with 4 gloo ranks on
one card).

    python -m nrslam_tpu_torch.parallel.multicard [N]

on a host with at least N visible cards (N: every visible card, at least
2). Builds the kernels from ``csrc/`` once, spawns N ranks (``dryrun.World``
with the NCCL backend: rank r on card r), then runs the keyframe-sharded
BA at K=8, P=768 (8 and 5 of 8 keyframes valid), the sharded pose-only
and joint solves at P=768 on the rigid scene against the whole-solver
kernels (pose 1e-5, flows 2e-4), the window BA partitioned over the
ranks' point blocks at W=5, P=768 and 4096 against the whole-solver BA
kernel (3e-5, bit for bit against one process) and the row-sharded frame
at 640x480 with 256 new keypoints (``dryrun.FRAME_RUNS``: P=768 for 6
frames, keyframes at frames 3 and 5, and P=4096 for 3, a keyframe at
frame 3), with ``dryrun``'s readings and gates (``report_ba``,
``report_solves``, ``report_points_ba``, ``report_frames``; with 4 ranks
the bytes against ``dryrun.PREDICTED``). Prints the cards' names and
power limits first, and raises at the first check outside its gates. A
measurement on several cards; ``chip_smoke.py`` needs one.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

from nrslam_tpu_torch import bench_problem, convert, kernels
from nrslam_tpu_torch.parallel import dryrun
from nrslam_tpu_torch.solver import bundle_adjustment as ba


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("multicard: no CUDA device")
    # cuBLAS deterministic too in the plain-driver process
    # (dryrun._plain_solves); read when the first cuBLAS handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    n = int(argv[0]) if argv else torch.cuda.device_count()
    if n < 2 or torch.cuda.device_count() < n:
        raise SystemExit(f"multicard: {n} ranks need {max(n, 2)} cards, "
                         f"{torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines())
    print(f"[multicard] {cards}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"[multicard] kernels built in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    with dryrun.World(n, dev, backend="nccl") as world:
        print(f"[multicard] {n} NCCL ranks, rank r on cuda:r, up in "
              f"{time.perf_counter() - t0:.2f} s")
        for n_valid in (8, 5):
            cam, poses0, L0, prob = bench_problem.ba_problem(
                n_valid=n_valid, device=dev, K=8, P=768)
            plain = ba.local_deformable_ba_plain(cam, poses0, L0, prob, 5, 32)
            outs = world.run("kf_sharded_ba", *convert.to_numpy(
                (cam, poses0, L0, prob)), 5, 32)
            dryrun.report_ba(
                "[multicard]", f"kf-sharded BA {n_valid}/8 valid",
                dryrun.ba_against_plain(outs, cam, poses0, L0, prob, plain),
                n, L0, prob)
        dryrun.report_solves("[multicard]", dryrun.solves_against_whole(
            world, dev, 0.0), n, 1e-5, 2e-4)
        for P in (768, 4096):
            dryrun.report_points_ba(
                "[multicard]", dryrun.points_ba_against_whole(
                    world, dev, 5, P), n, 3e-5)
        for P, kfs in dryrun.FRAME_RUNS:
            r = dryrun.frames_against_single(world, dev, P, kfs,
                                             gather_graph=P <= 768)
            dryrun.report_frames("[multicard]", f"{n} cards", r, P, kfs,
                                 dryrun.PREDICTED[P] if n == 4 else None)
    print("[multicard] ok")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
