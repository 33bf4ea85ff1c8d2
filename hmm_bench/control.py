"""The readings that the limits of ``correct`` are set from, for one cell.

    python3 -m hmm_bench.control --workload <name> --seeds 11,12,13 [--seconds 1]

In one process, for each seed: the cell's set-up, a short window at the
cell's own size and load, and the check of its last segment, once with
the program's outputs (the lower readings) and once with the control's:
the reference computed in bfloat16, the precision below the float32 that
the configuration states, in the program's place (the upper readings).
Prints one JSON line per seed, with the control's verdict by the
harness's own limits and the numbers it takes beyond them, and, last, the
largest program reading and the smallest control reading of each number
over the seeds.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

from hmm_bench import registry
from hmm_bench import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hmm_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    conf = registry.config(root, bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    print(R._card_line(), file=sys.stderr)
    dev = torch.device("cuda", torch.cuda.current_device())
    prog, ctrl, verdicts = {}, {}, []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = R.run_cell(conf, traffic, seed, args.seconds, False, dev, [], [], control=True)
        nums = {k: v for k, (v, _) in res["checked"].items()}
        print(json.dumps({"seed": seed, "correct": res["correct"], "program": nums,
                          "control_correct": not res["control_over"],
                          "control_over_limit": res["control_over"],
                          "control": res["control"]}), flush=True)
        verdicts.append(not res["control_over"])
        for k, v in nums.items():
            prog[k] = max(prog.get(k, -math.inf), v)
        for k, v in res["control"].items():
            ctrl[k] = min(ctrl.get(k, math.inf), v)
    print(json.dumps({"workload": args.workload, "program_max": prog, "control_min": ctrl,
                      "control_correct_on_any_seed": any(verdicts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
