"""The program's span log on a traced stretch's timeline
(`harness/spans.py`): the offset fixed from the `data.h2d` spans' copy
calls, device-idle time inside spans, the wrappers' self time, and the
readers' silence where the program logs nothing; on a card, a tiny
traced train stretch."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import tiny_cell

T0 = 1_792_000_000_000_000_000  # ns on the Unix clock
ZERO = T0 - 5_000_000  # the trace's start: trace µs = (ns - ZERO) / 1e3


def _span(name, start_us, end_us, parent=None, unit=None):
    """A span at `start_us`..`end_us` of the trace's timeline."""
    return SimpleNamespace(name=name, start_ns=ZERO + int(start_us * 1e3),
                           end_ns=ZERO + int(end_us * 1e3), parent=parent,
                           unit=unit)


def _stretch(gaps=(4.0, 5.0, 6.0, 5.0, 5.0)):
    """Five steps 1 ms apart: each a `data.h2d` span with three copy
    calls, the last ending `gap` µs before the span's end, then a
    `train_step` span that launches a kernel, with a device→host copy
    call between steps that no `data.h2d` span holds."""
    from portbench.harness.trace import Trace

    log, host, device = [], [], []
    for k, gap in enumerate(gaps):
        t = 1000.0 * k + 100.0
        log.append(_span("data.h2d", t, t + 60.0 + gap, unit=k))
        for c in range(3):
            host.append(("cudaMemcpyAsync", t + 5.0 + 20.0 * c,
                         t + 20.0 + 20.0 * c))
        device.append(("Memcpy HtoD (Pinned -> Device)", t + 10.0, t + 90.0))
        step = _span("train_step", t + 200.0, t + 700.0, unit=k)
        log.append(step)
        log.append(_span("kernel.k", t + 300.0, t + 340.0, parent=step,
                         unit=k))
        device.append(("gemm", t + 400.0, t + 900.0))
        host.append(("cudaMemcpyAsync", t + 910.0, t + 915.0))
    window = (min(s for _, s, _ in device), max(e for _, _, e in device))
    return Trace(device, host, window, units=len(gaps)), log


def _requests(gaps=(4.0, 5.0, 6.0, 5.0, 5.0)):
    """Five requests 76 ms apart, served one after another: each a
    `data.h2d` span with three pageable copy calls (1.1 ms, 1.1 ms and
    20 µs), the last ending `gap` µs before the span's end, after the
    answer fetch of the request before (a 1.4 ms call that waits for the
    card, then two short ones, device to host) and before the
    preprocessing's two short copies of constants. Shifted 35 µs early,
    a span would hold the fetch's last call in place of its own last one
    as tightly: the directions of the device's copies tell them apart."""
    from portbench.harness.trace import Trace

    log, host, device = [], [], []
    for k, gap in enumerate(gaps):
        t = 76000.0 * k + 2000.0
        log.append(_span("data.h2d", t, t + 2230.0 + gap, unit=k))
        host += [("cudaMemcpyAsync", t - 1500.0, t - 60.0),
                 ("cudaMemcpyAsync", t - 50.0, t - 40.0),
                 ("cudaMemcpyAsync", t - 35.0, t - 30.0),
                 ("cudaMemcpyAsync", t + 12.0, t + 1100.0),
                 ("cudaMemcpyAsync", t + 1110.0, t + 2200.0),
                 ("cudaMemcpyAsync", t + 2210.0, t + 2230.0),
                 ("cudaMemcpyAsync", t + 2400.0, t + 2410.0),
                 ("cudaMemcpyAsync", t + 2600.0, t + 2605.0)]
        device += [("Memcpy DtoH (Device -> Pageable)", t - 80.0, t - 61.0),
                   ("Memcpy DtoH (Device -> Pageable)", t - 45.0, t - 41.0),
                   ("Memcpy DtoH (Device -> Pageable)", t - 33.0, t - 31.0),
                   ("Memcpy HtoD (Pageable -> Device)", t + 20.0, t + 1090.0),
                   ("Memcpy HtoD (Pageable -> Device)", t + 1120.0,
                    t + 2190.0),
                   ("Memcpy HtoD (Pageable -> Device)", t + 2215.0,
                    t + 2225.0),
                   ("Memcpy HtoD (Pageable -> Device)", t + 2405.0,
                    t + 2408.0),
                   ("Memcpy HtoD (Pageable -> Device)", t + 2602.0,
                    t + 2604.0),
                   ("gemm", t + 2700.0, t + 70000.0)]
    window = (min(s for _, s, _ in device), max(e for _, _, e in device))
    return Trace(device, host, window, units=len(gaps)), log, [
        76000.0 * k + 4230.0 for k in range(len(gaps))]


@pytest.mark.parametrize("layout", ["steps", "requests"])
def test_the_offset_ends_the_median_span_at_its_last_copy_call(layout):
    from portbench.harness import spans

    if layout == "steps":
        trace, log = _stretch()
        last = [1000.0 * k + 160.0 for k in range(5)]
    else:
        trace, log, last = _requests()
    placed = spans.on_trace(trace, log)
    # the median gap, 5 µs, is taken out: each span now ends gap − 5 µs
    # after its last copy call
    ends = [e for span, _, e in placed if span.name == "data.h2d"]
    assert ends == pytest.approx([x + g - 5.0 for x, g in
                                  zip(last, (4.0, 5.0, 6.0, 5.0, 5.0))])
    # every copy call of a span lies inside it, within the tolerance
    for span, s, e in placed:
        if span.name == "data.h2d":
            inside = [c for c in trace.host_ops
                      if s - spans.TOLERANCE_US <= c[1]
                      and c[2] <= e + spans.TOLERANCE_US]
            assert len(inside) == 3


def test_the_offset_holds_for_any_distance_between_the_clocks():
    from portbench.harness import spans

    trace, log = _stretch()
    shift = 123_456_789_012  # ns: the log stamped on another origin
    moved = [SimpleNamespace(**{**vars(s), "start_ns": s.start_ns + shift,
                                "end_ns": s.end_ns + shift}) for s in log]
    first = [(s, e) for _, s, e in spans.on_trace(trace, log)]
    second = [(s, e) for _, s, e in spans.on_trace(trace, moved)]
    assert second == pytest.approx(first)


def test_idle_inside_spans_counts_each_instant_once():
    from portbench.harness import spans
    from portbench.harness.trace import Trace

    device = [("gemm", 0.0, 10.0), ("gemm", 50.0, 60.0),
              ("gemm", 100.0, 110.0)]
    trace = Trace(device, [], (0.0, 110.0), units=2)
    assert spans.idle(trace) == [[10.0, 50.0], [60.0, 100.0]]
    outer = _span("train_step", 0.0, 0.0)  # names alone are read below
    placed = [(outer, 5.0, 30.0),  # idle 10..30
              (_span("data.pin", 0, 0), 20.0, 40.0),  # overlaps: 30..40 more
              (_span("train_step", 0, 0), 25.0, 28.0),  # nested: nothing
              (_span("data.next", 0, 0), 55.0, 70.0)]  # idle 60..70
    assert spans.idle_inside_us(trace, placed, lambda n: True) == 40.0
    assert spans.idle_inside_us(
        trace, placed, lambda n: n == "train_step") == 20.0
    assert spans.idle_inside_us(
        trace, placed, lambda n: n.startswith("data.")) == 30.0


def test_the_readings_a_unit():
    from portbench.harness import spans

    trace, log = _stretch()
    # the offset takes the median gap, 5 µs, as none: every span lands
    # 5 µs before where it was stamped, train_step at t + 195 .. t + 695,
    # and holds the idle stretch from there to the gemm at t + 400
    assert spans.idle_ms_per_unit(
        trace, log, lambda n: n == "train_step") == pytest.approx(0.205)
    assert spans.idle_ms_per_unit(
        trace, log, lambda n: n == "request") is None
    # the kernel span's 40 µs a step, its parent's self time less them
    assert spans.self_ms_per_unit(
        trace, log, lambda n: n.startswith("kernel.")) == pytest.approx(0.04)
    assert spans.self_ms_per_unit(
        trace, log, lambda n: n == "train_step") == pytest.approx(0.46)


@pytest.mark.parametrize("metric", ["idle_host_data_ms.train",
                                    "idle_step_host_ms.train",
                                    "wrapper_host_ms.train"])
def test_a_program_without_spans_reads_nothing(metric, monkeypatch):
    """The parent's program has no span log, and a log that dropped
    records is not read: the readers give nothing and do not raise."""
    import sys
    import types

    import gdl_tpu_torch.utils as utils
    from portbench.harness.spec import metric_reader

    trace, log = _stretch()
    ctx = SimpleNamespace(kind="train", trace=trace)
    profiling = types.ModuleType("gdl_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "gdl_tpu_torch.utils.profiling",
                        profiling)
    monkeypatch.setattr(utils, "profiling", profiling, raising=False)
    assert metric_reader(metric).read(ctx) is None
    profiling.spans, profiling.dropped = lambda: log, 1
    assert metric_reader(metric).read(ctx) is None
    profiling.dropped = 0
    assert metric_reader(metric).read(ctx) is not None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["resnet18_dgl_cremad.train_b64",
                                      "swin_b_dgl_vggsound.serve_b16"])
def test_a_traced_stretch_on_the_card_places_the_spans(workload, cuda_device):
    """A tiny traced stretch: every `data.h2d` span, shifted, holds the
    three copy calls it issued (wave, frames, label) within 20 µs, and no
    idle reading exceeds the stretch's idle ms a unit."""
    import time

    from gdl_tpu_torch.utils import profiling
    from portbench.harness import spans
    from portbench.harness.spec import metric_reader

    cell = tiny_cell(workload)
    kind = cell.traffic["driver"]
    cell.traffic["trace_steps" if kind == "train" else "trace_requests"] = 8
    profiling.reset_spans()
    out = cell.driver.run(cell, 2147483650, 0.5, True, cuda_device,
                          time.perf_counter())
    trace, log = out["trace"], spans.closed_spans(profiling)
    placed = spans.on_trace(trace, log)
    h2d = [(s, e) for span, s, e in placed if span.name == "data.h2d"]
    assert len(h2d) == 8
    calls = spans._calls(trace)
    for s, e in h2d:
        held = [c for c in calls if c[1] > s - spans.TOLERANCE_US
                and c[0] < e + spans.TOLERANCE_US]
        assert len(held) == 3, (s, e, held)
        assert all(s - spans.TOLERANCE_US <= cs and ce <= e
                   + spans.TOLERANCE_US for cs, ce in held)
    idle_ms = (trace.window_s - trace.busy_s) * 1e3 / trace.units
    names = (["idle_host_data_ms.train", "idle_step_host_ms.train"]
             if kind == "train" else ["idle_request_host_ms.serve"])
    for metric in names:
        value = metric_reader(metric).read(out["ctx"])
        assert value is not None and 0 <= value <= idle_ms, metric
    assert metric_reader(f"wrapper_host_ms.{kind}").read(out["ctx"]) > 0
