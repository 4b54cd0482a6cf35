"""The check's control and its lower readings, for setting a cell's limits
(``slambench/limits/<cell>.json``); the benchmark's runs never run it:

    python3 -m slambench.control --workload <cell> --seeds 11,12,13 \
        --seconds 5

For each seed, in one process: a run of the cell with a window of
``--seconds`` and its check (the program against the plain reference:
the lower readings), then the control (the reference in TF32, the
precision below the configuration's float32 with TF32 off, in the
program's place: the upper readings). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)

    import torch

    from slambench import run

    if not torch.cuda.is_available():
        print("slambench.control: needs a CUDA device", file=sys.stderr)
        return 2
    _, cell, cfg, mix, limits = run.load_cell(args.workload)
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, cfg, mix, limits, seed, args.seconds, False,
                           device, control=True,
                           log=lambda s: print(s, file=sys.stderr,
                                               flush=True))
        print(json.dumps({
            "seed": seed, "attempted": res["attempted"],
            "failed": res["failed"], "correct": res["correct"],
            "control_correct": res["control_correct"],
            "program": {**{n: c["value"] for n, c in res["checks"].items()},
                        **res["readings"]},
            "control": {**{n: c["value"]
                           for n, c in res["control_checks"].items()},
                        **res["control_readings"]}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
