"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the program's compared numbers on one request of the
timed path (after the warm-up request, so every step is a replay), and the
control's: the plain reference put in the program's place and computed in
the precision below the configuration's (``--control``, default fp8 for
bf16).

    python3 benchmark/tools/readings.py --workload <cell> --seeds 11,12,13 \\
        [--control fp8]

Prints one JSON line per seed and side. The benchmark's runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import runner, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="fp8")
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    runner.set_environment(spec.ROOT)
    import torch

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    print(f"card: {runner.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        drv = cell.driver().Driver(cell, seed, dev)
        t0 = time.perf_counter()
        drv.setup()
        drv.request(0)
        t1 = time.perf_counter()
        drv.release()
        out = {"seed": seed, "rows": drv.rows(0)}
        out["program"], _ = drv.check([0])
        rows = {"program": drv.last_rows}
        t2 = time.perf_counter()
        if args.control:
            out[args.control], _ = drv.check([0], control=args.control)
            rows[args.control] = drv.last_rows
        t3 = time.perf_counter()
        if "margin" in drv.last_truth:
            rows["margin"] = drv.last_truth["margin"].tolist()
        out["per_row"] = {side: {k: [float(f"{x:.4g}") for x in v] for k, v in r.items()}
                          if isinstance(r, dict) else [float(f"{x:.4g}") for x in r]
                          for side, r in rows.items()}
        out["seconds"] = {"program": t1 - t0, "check": t2 - t1, "control": t3 - t2}
        print(json.dumps(out), flush=True)
        del drv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
