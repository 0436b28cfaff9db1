"""The control of `correct`: the plain reference computed in float64, the
precision below the exact decimal arithmetic the configurations state,
put in the program's place. It has to come out as not correct.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's tables (from the configuration's `data_seed`)
and statement instances as a run draws them, every instance answered by the exact reference and by the float64
one, and the float64 rows (cut at the LIMIT, as the program returns them)
judged as a run judges the program's. Prints one JSON line a seed with the
control's `mismatched_cells`. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def control_cells(workload: str, seed: int, device, scale_factor=None) -> dict:
    import torch

    from portbench import compare, data, traffic
    from portbench.reference.common import Ctx
    from portbench.run import load_spec

    _, cell, config = load_spec(workload)
    mix = traffic.load_mix(cell["traffic"])
    sf = config["scale_factor"] if scale_factor is None else scale_factor
    t0 = time.monotonic()
    tables = data.generate(config["generator"], sf, config["data_seed"], device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    exact, low = Ctx(tables, device), Ctx(tables, device, "float64")
    per = {}
    for inst in traffic.distinct(traffic.streams(mix, seed)):
        mod = importlib.import_module(f"portbench.reference.{mix['family']}.{inst.query}")
        want = mod.run(exact, inst.param_dict)
        got = mod.run(low, inst.param_dict)
        n = got.total if got.limit is None else min(got.limit, got.total)
        per[inst.id] = compare.mismatched_cells(got.rows[:n], want)
    return {"workload": workload, "seed": seed, "mismatched_cells": sum(per.values()),
            "by_instance": per, "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from portbench.run import CACHE_ENV

    os.environ.update(CACHE_ENV)
    import torch

    if not torch.cuda.is_available():
        print("the control runs at the cell's own size on the card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control_cells(args.workload, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
