"""Find the knee of a serving cell: the highest rate the program sustains.

    python3 portbench/sweep.py --workload <serving cell> --seed <n> \\
        --rates 8,10,12,14 [--seconds 10]

One process builds the cell's server once, then serves the cell's mix at
each rate in turn for `--seconds`, and prints one JSON line a rate: the
latency's median, 95th percentile and maximum, the clips answered a
second, and the growth of the latency over the run (the last tenth's
median over the first tenth's): near 1 where the rate is sustained,
rising where the queue grows. The cell's rate is set once from this, at
about four fifths of the knee; runs of the cell never search for one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import numpy as np

    from portbench.drivers.serve import ProgramServer, open_loop
    from portbench.harness import inputs
    from portbench.harness.device import nvidia_smi, require_cuda, \
        set_precision
    from portbench.harness.spec import find_cell

    cell = find_cell(args.workload)
    device = require_cuda(cell.chips)
    set_precision()
    t = cell.traffic
    pool = inputs.batch_pool(args.seed, t["pool"], t["batch"], cell.config)
    with contextlib.redirect_stdout(sys.stderr):
        server = ProgramServer(cell, args.seed, device)
        for raw in pool[:t["warmup_requests"]]:
            server.serve(raw)
    for rate in [float(r) for r in args.rates.split(",")]:
        n = int(round(rate * args.seconds))
        lat, _, window_s, _ = open_loop(server, pool, n, rate, set())
        tenth = max(n // 10, 1)
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate, "requests": n,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "max_ms": float(lat.max()) * 1e3,
            "clips_per_s": n * t["batch"] / window_s,
            "growth": float(np.median(lat[-tenth:]) / np.median(lat[:tenth])),
            "card": nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
