"""The "serve" driver: an open loop of requests of raw clips served one at
a time through the program's `ServedModel.eval_batch` (eval
preprocessing on the device, both encoders, the head, the argmaxes).

Requests arrive at `rate_per_s` for `--seconds`, rate × seconds of
them, one every 1 / rate. Each request is handed to the server when it
is due, or when the one before it has returned if that is later; its
latency runs from when it was due until its logits and argmaxes are on
the host, so a stall delays every request queued behind it.
`serve_p95_ms` is the 95th percentile of all latencies in the window.
Below the knee the clips answered a second are the offered rate, so the
per-layer `mfu.serve` reads the service time: from a request's hand-over
to its answer. With `--trace 1` a traced stretch of `trace_requests`
more requests follows, served back to back so that the device's idle
share is that of serving, not of the waits between arrivals, after two
requests under the profiler untraced (`harness/trace.py`).

After the window, a sample of `check_requests` requests drawn from the
seed is compared with the plain reference's eval forward of the same
raw batches (`harness/compare.py`).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import compare, inputs
from portbench.harness.device import set_precision
from portbench.harness.trace import traced
from portbench.harness.weights import load_weights
from portbench.reference.dgl import eval_logits, reference_model


class ProgramServer:
    """The system under test: gdl_tpu_torch's `ServedModel` over the
    seeded weights."""

    def __init__(self, cell, seed: int, device):
        from gdl_tpu_torch.config import Config
        from gdl_tpu_torch.serve import ServedModel, build_model

        cfg = Config(**cell.config["program"], device=str(device))
        with torch.device(device):  # initial values are overwritten below
            model = build_model(cfg, seed=None)
        load_weights(model, seed, cell.config["init"])
        self.served = ServedModel(model, cfg, device, torch.float32)

    def serve(self, raw: dict):
        """→ (logits (out, out_a, out_v), answers (pred, pred_a, pred_v)),
        numpy, on the host."""
        out = self.served.eval_batch(raw)
        logits = tuple(t.float().cpu().numpy() for t in out["logits"])
        preds = tuple(out[k].cpu().numpy() for k in ("pred", "pred_a",
                                                     "pred_v"))
        return logits, preds

    def close(self) -> None:
        self.served = None


class ControlServer:
    """The control: the reference's eval forward put in the program's
    place, its products in TF32 where the configuration states float32."""

    def __init__(self, cell, seed: int, device):
        self.config, self.device = cell.config, device
        self.model = reference_model(cell.config, seed, device)

    def serve(self, raw: dict):
        prior = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            logits = eval_logits(self.model, self.config, raw, self.device)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prior
        host = tuple(t.float().cpu().numpy() for t in logits)
        return host, tuple(x.argmax(axis=1) for x in host)

    def close(self) -> None:
        self.model = None


SPIN_S = 0.005  # the last stretch of a wait is spent polling the clock


def wait_until(when: float) -> None:
    """Sleep until `SPIN_S` before `when`, then poll: the host core is
    awake when the request is due, whatever the gap before it."""
    rest = when - time.perf_counter() - SPIN_S
    if rest > 0:
        time.sleep(rest)
    while time.perf_counter() < when:
        pass


def open_loop(server, pool: list, count: int, rate: float, keep: set):
    """Serve `count` requests, one due every 1 / `rate` s (back to back
    where `rate` is 0) → (latencies s, service times s, window s,
    {request index: answer} for the indices in `keep`)."""
    latencies, service = np.empty(count), np.empty(count)
    kept = {}
    t0 = time.perf_counter()
    for i in range(count):
        due = t0 + i / rate if rate else time.perf_counter()
        wait_until(due)
        start = time.perf_counter()
        answer = server.serve(pool[i % len(pool)])
        end = time.perf_counter()
        latencies[i], service[i] = end - due, end - start
        if i in keep:
            kept[i] = answer
    return latencies, service, time.perf_counter() - t0, kept


def check_sample(seed: int, count: int, requests: int) -> set:
    rng = np.random.default_rng(inputs.sub_seed(seed, 4))
    return set(rng.choice(requests, size=min(count, requests),
                          replace=False).tolist())


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, window: bool = True, server=None) -> dict:
    from gdl_tpu_torch import kernels

    traffic, config = cell.traffic, cell.config
    set_precision()
    batch, rate = traffic["batch"], traffic["rate_per_s"]
    pool = inputs.batch_pool(seed, traffic["pool"], batch, config)
    server = server or ProgramServer(cell, seed, device)
    for raw in pool[:traffic["warmup_requests"]]:
        server.serve(raw)
    gc.collect()  # every run starts its window with the same collector
    out = {"trace": None, "ctx": None, "e2e": {}, "failed": 0}
    if window:
        n = max(int(round(rate * seconds)), 1)
        sample = check_sample(seed, traffic["check_requests"], n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        lat, service, window_s, kept = open_loop(server, pool, n, rate,
                                                 sample)
        out["launches"] = {name: v / n for name, v in
                           kernels.launch_counts.items() if v}
        out["e2e"] = {"setup_s": t0 - t_start,
                      "serve_p95_ms": float(np.percentile(lat, 95)) * 1e3}
        out["latency_ms"] = {
            "p50": float(np.percentile(lat, 50)) * 1e3,
            "max": float(lat.max()) * 1e3,
            "service_p50": float(np.percentile(service, 50)) * 1e3,
            "clips_per_s": n * batch / window_s}
        out["ctx"] = SimpleNamespace(kind="serve", steps=n, clips=n * batch,
                                     window_s=window_s,
                                     service_s=float(service.sum()),
                                     batch=batch, config=config,
                                     traffic=traffic, trace=None)
        if trace:
            k = traffic["trace_requests"]
            with traced(device, lambda: open_loop(server, pool, 2, 0.0,
                                                  set())) as holder:
                open_loop(server, pool, k, 0.0, set())
            holder.trace.units = k
            out["trace"] = out["ctx"].trace = holder.trace
            n += k
    else:  # readings only: the sample served back to back
        sample = set(range(traffic["check_requests"]))
        *_, kept = open_loop(server, pool, len(sample), 0.0, sample)
        n = len(sample)
    out["attempted"] = n
    if device.type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    server.close()
    del server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    model = reference_model(config, seed, device)
    refs = {}
    served, reference = [], []
    for i in sorted(kept):
        p = i % len(pool)
        if p not in refs:
            refs[p] = tuple(t.float().cpu().numpy() for t in
                            eval_logits(model, config, pool[p], device))
        served.append(kept[i])
        reference.append(refs[p])
    out["numbers"] = compare.serve_numbers(served, reference)
    return out
