"""Run one cell of the benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, and when a module of JAX or of the JAX package is loaded
once the window has closed. The program's own prints go to standard
error; the last line of standard output is the JSON result: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`: each number that decided
`correct` beside its limit, which also end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# transformers and its kin load JAX where they find it: not in this run
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def layer_metrics(cell, ctx) -> dict:
    """{name: {value, unit}} of the cell's per-layer metrics that found
    something to read."""
    from portbench.harness.spec import metric_reader

    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of `cell` on `device` → the result object (without the
    check for a card, which `main` makes)."""
    from portbench.harness import compare
    from portbench.harness.device import describe, nvidia_smi

    with contextlib.redirect_stdout(sys.stderr):
        out = cell.driver.run(cell, seed, seconds, trace, device, t_start)
    correct, checks = compare.verdict(out["numbers"], cell.limits)
    dev = describe(device, cell.chips)
    if "memory_peak_bytes" in out:
        dev["memory_peak_bytes"] = out["memory_peak_bytes"]
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        tr = out["trace"]
        result["metrics"] = layer_metrics(cell, out["ctx"])
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in out["e2e"]]
        if missing:
            raise KeyError(f"the {cell.traffic['driver']} driver gives no "
                           f"{missing}")
        result["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = dev
    print(json.dumps({"launches_per_unit": out.get("launches"),
                      "latency_ms": out.get("latency_ms"),
                      "nvidia_smi": nvidia_smi() if device.type == "cuda"
                      else None}), file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.device import (
        NoDevice,
        forbidden_modules,
        require_cuda,
    )
    from portbench.harness.spec import find_cell

    cell = find_cell(args.workload)
    try:
        device = require_cuda(cell.chips)
    except NoDevice as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device)
    found = forbidden_modules()
    if found:
        print(f"portbench: {found} loaded in the measured process; no "
              f"result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
