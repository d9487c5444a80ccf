"""Timing helpers shared by the kernel bench scripts (`bench_sa_eval`,
`bench_mlp`): CUDA-event medians of single calls, a run of calls between
two events, a torch.profiler split of one call's device time by kernel
name, and the runner that times several checkouts of the repository in
turns, each in a process of its own.

A bench script run with `--roots DIR ...` is started again by path for
each DIR with `PYTHONPATH=DIR`, so its worker imports the kernels and ops
of that checkout. That checkout may predate this module, so each script
first adds its own directory to the package's search path, after the
checkout's own: these helpers then come from the script's checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPS = 20


def cuda_ms(fn, reps=REPS, warmup=3):
    """Median device ms of one call, each call between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def run_ms(fn, reps=REPS):
    """Device ms of one call within a run of `reps` calls between two
    CUDA events (the host enqueues ahead, so its own time hides)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def split_ms(fn, part_of, traced=10):
    """Device ms of one call of `fn`, by part: a torch.profiler trace of
    `traced` calls, each kernel filed under `part_of(kernel name)`.
    Returns ({part: ms}, {kernel name: ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            fn()
        torch.cuda.synchronize()
    split, names = {}, {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        if t <= 0 or ev.key.startswith("cudaLaunch"):
            continue
        part = part_of(ev.key)
        split[part] = split.get(part, 0.0) + t / 1e3 / traced
        names[ev.key[:100]] = t / 1e3 / traced
    return split, names


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def run_roots(script: str, roots, mark: str):
    """Run `script --worker` once for each checkout in `roots`, in that
    order, each in its own process with the checkout as its working
    directory and PYTHONPATH; yields the result each printed on its line
    starting with `mark`, with "root" added."""
    for root in roots:
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--worker"],
            cwd=root, env=env, capture_output=True, text=True, check=False)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(mark)]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{root}: no result (exit {proc.returncode})\n"
                               f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        res = json.loads(lines[-1][len(mark):])
        res["root"] = root
        yield res
