"""Readings of the numbers that decide `correct`, for setting their
limits: the program's, on many seeds, and those of the control (the
plain reference put in the program's place in the nearest precision
below the configuration's: TF32 products where it states float32 with
TF32 off) and of planted faults, on a few.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --arm program|tf32|half_batch [--out readings.jsonl]

`program` drives the cell's own run without its measured window (the
first steps of a training cell, a sample of requests of a serving cell
served back to back) and compares as a run does. `tf32` puts the
reference in TF32 in the program's place; `half_batch` (training) puts
the float32 reference in its place with each step seeing half of its
batch, the mean taken over that half. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, arm: str, device) -> dict:
    from portbench.drivers import serve, train
    from portbench.harness import compare, inputs
    from portbench.harness.device import set_precision

    set_precision()
    if arm == "program":
        return cell.driver.run(cell, seed, 0.0, False, device,
                               time.perf_counter(), window=False)["numbers"]
    if cell.traffic["driver"] == "serve":
        if arm != "tf32":
            raise ValueError(f"a serving cell has no arm {arm!r}")
        server = serve.ControlServer(cell, seed, device)
        return serve.run(cell, seed, 0.0, False, device,
                         time.perf_counter(), window=False,
                         server=server)["numbers"]
    t = cell.traffic
    pool = inputs.batch_pool(seed, t["checked_steps"], t["batch"], cell.config)
    ref = train.reference_readings(cell, seed, pool, device)
    prog = train.reference_readings(cell, seed, pool, device,
                                    tf32=arm == "tf32",
                                    half_batch=arm == "half_batch")
    return compare.train_numbers(prog, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--arm", default="program",
                    choices=["program", "tf32", "half_batch"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench.harness.device import require_cuda
    from portbench.harness.spec import find_cell

    cell = find_cell(args.workload)
    device = require_cuda(cell.chips)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            numbers = readings(cell, seed, args.arm, device)
        line = json.dumps({"workload": args.workload, "arm": args.arm,
                           "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
