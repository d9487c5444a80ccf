"""The "train" driver: closed-loop DGL training through the program's own
entry, `build_harness` and `train_one_epoch` (the path `main_dgl`
takes), fed raw host batches from a seeded pool as a `Loader` yields
them.

Set-up builds one harness over the seeded weights, drives it through
its first `checked_steps` steps (each a call of `train_one_epoch` on one
batch of the pool, all rows distinct; they also warm up every shape and
build the kernels), and hands that same harness to the window. The
window calls `train_one_epoch` once over the pool, cycled, until
`--seconds` have passed on the host clock; it ends when the call has
returned and the device is synchronised. `train_clips_per_s` is the
clips of every step the call took over the window. With `--trace 1` a
traced stretch of `trace_steps` more steps follows, after two steps
under the profiler untraced (`harness/trace.py`).

After the window (its peak memory read, the harness freed) the plain
reference trains its own model from the same seeded weights on the same
batches, with an augmentation generator seeded as the program's, and
the first steps are compared (`harness/compare.py`).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench.harness import compare, inputs
from portbench.harness.device import set_precision
from portbench.harness.trace import traced
from portbench.harness.weights import load_weights
from portbench.reference.dgl import ReferenceTrainer


def aug_seed(seed: int) -> int:
    """The seed of the augmentation (and DropPath) generator, which the
    program takes as its `random_seed` (numpy's seed: under 2**32)."""
    return inputs.sub_seed(seed, 3) % 2 ** 32


class TimedBatches:
    """The pool, cycled from `start`, until `seconds` have passed since
    `t0` on the host clock; `count` is the batches handed out."""

    def __init__(self, pool: list, start: int, seconds: float, t0: float):
        self.pool, self.start, self.seconds, self.t0 = pool, start, seconds, t0
        self.count = 0

    def __iter__(self):
        while time.perf_counter() - self.t0 < self.seconds:
            yield self.pool[(self.start + self.count) % len(self.pool)]
            self.count += 1


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().float()))


def _start_state(module: torch.nn.Module) -> dict:
    return {n: t.detach().clone() for n, t in module.state_dict().items()
            if t.is_floating_point()}


def _changes(module: torch.nn.Module, start: dict) -> dict:
    state = module.state_dict()
    return {n: _norm(state[n].float() - s.float()) for n, s in start.items()}


class ProgramTrainer:
    """The system under test: gdl_tpu_torch's harness over the seeded
    weights."""

    def __init__(self, cell, seed: int, device):
        from gdl_tpu_torch.config import Config
        from gdl_tpu_torch.serve import build_model
        from gdl_tpu_torch.train.loop import build_harness

        config = cell.config
        cfg = Config(**config["program"], random_seed=aug_seed(seed),
                     device=str(device))
        with torch.device(device):  # initial values are overwritten below
            model = build_model(cfg, seed=None)
        load_weights(model, seed, config["init"])
        self.wd = config["recipe"]["weight_decay"]
        self.h = build_harness(cfg, model, config["steps_per_epoch"])

    def train(self, batches) -> None:
        from gdl_tpu_torch.train.loop import train_one_epoch

        train_one_epoch(self.h, batches, 0)

    def checked(self, batches: list) -> dict:
        """Each batch one step through the window's own call → the losses,
        the first gradient's leaf norms as the optimizer got it, and the
        leaves' change over the steps."""
        from gdl_tpu_torch.train.loop import train_one_epoch

        model, opt = self.h.model, self.h.optimizer
        start = _start_state(model)
        losses, grad = [], {}
        for k, batch in enumerate(batches):
            losses.append(float(train_one_epoch(self.h, [batch], 0)["loss"]))
            if k == 0:  # momentum after one step = g + wd · p0
                for n, p in model.named_parameters():
                    buf = opt.state.get(p, {}).get("momentum_buffer")
                    grad[n] = 0.0 if buf is None else _norm(
                        buf.float() - self.wd * start[n].float())
        return {"losses": losses, "grad": grad,
                "change": _changes(model, start)}

    def close(self) -> None:
        self.h = None


def reference_readings(cell, seed: int, batches: list, device,
                       tf32: bool = False, half_batch: bool = False) -> dict:
    """The reference's three steps (or a control arm: TF32 products, or
    half of each batch) → the readings `ProgramTrainer.checked` gives."""
    ref = ReferenceTrainer(cell.config, seed, device, aug_seed(seed),
                           half_batch=half_batch)
    start = _start_state(ref.model)
    losses, grad = [], {}
    prior = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for k, batch in enumerate(batches):
            loss, grads = ref.step(batch, keep_grads=k == 0)
            losses.append(loss)
            if k == 0:
                grad = {n: _norm(grads[n]) if n in grads else 0.0
                        for n, _ in ref.model.named_parameters()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prior
    return {"losses": losses, "grad": grad,
            "change": _changes(ref.model, start)}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, window: bool = True) -> dict:
    from gdl_tpu_torch import kernels

    traffic, config = cell.traffic, cell.config
    set_precision()
    batch, n_checked = traffic["batch"], traffic["checked_steps"]
    pool = inputs.batch_pool(seed, traffic["pool"], batch, config)
    system = ProgramTrainer(cell, seed, device)
    prog = system.checked(pool[:n_checked])
    gc.collect()  # every run starts its window with the same collector
    out = {"attempted": n_checked, "failed": 0, "trace": None, "e2e": {},
           "ctx": None}
    if window:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        timed = TimedBatches(pool, n_checked, seconds, t0)
        system.train(timed)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
        steps = timed.count
        out["attempted"] += steps
        out["launches"] = {k: v / steps for k, v in
                           kernels.launch_counts.items() if v}
        out["e2e"] = {"setup_s": t0 - t_start,
                      "train_clips_per_s": steps * batch / window_s}
        out["ctx"] = SimpleNamespace(kind="train", steps=steps,
                                     clips=steps * batch, window_s=window_s,
                                     batch=batch, config=config,
                                     traffic=traffic, trace=None)
        if trace:
            n_traced = traffic["trace_steps"]
            with traced(device, lambda: system.train(pool[:2])) as holder:
                system.train([pool[i % len(pool)] for i in range(n_traced)])
            holder.trace.units = n_traced
            out["trace"] = out["ctx"].trace = holder.trace
            out["attempted"] += n_traced
        if device.type == "cuda":
            out["memory_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(device))
    system.close()
    del system
    _free(device)
    ref = reference_readings(cell, seed, pool[:n_checked], device)
    out["numbers"] = compare.train_numbers(prog, ref)
    out["readings"] = {"program": prog, "reference": ref}
    return out
