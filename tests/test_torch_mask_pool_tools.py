"""The tools around kernels #14 (the dropout-mask generator) and #16 (the
stem max-pool's backward) that run on the CPU: bench_mask_pool's refusal
without a card, its arguments, its calls against chip_smoke.py's, its
bytes, operations and bounds against chip_smoke's cost functions, and its
calls themselves on CPU tensors (the ops' plain versions, and the library
calls it times beside them)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_mask_pool_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m",
                           "gdl_tpu_torch.bench_mask_pool", "--roots", "a",
                           "b", "--out", "never.json"],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
    assert not (REPO / "never.json").exists()


@pytest.mark.parametrize("argv,bad", [
    (["--roots"], False), (["--roots", "p", ".", ".", "p"], False),
    (["--out", "x.json"], False), (["--worker"], False),
    (["--bogus"], True), (["--out"], True), (["--roots", "--out"], True)])
def test_bench_mask_pool_parses_its_arguments(argv, bad, monkeypatch):
    """Unknown options and a missing value are refused by argparse (exit
    2 before anything else); a valid command line gets past parsing to
    the card check, which refuses here with 2 and prints no result."""
    from gdl_tpu_torch import bench_mask_pool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if bad:
        with pytest.raises(SystemExit) as e:
            bench_mask_pool.main(argv)
        assert e.value.code == 2
    else:
        assert bench_mask_pool.main(argv) == 2


def test_bench_mask_pool_times_chip_smokes_calls():
    """The 28 masks of an mmformer_n step and the two stems' pools are
    chip_smoke.py's, and one step's launches are chip_smoke's counts."""
    from gdl_tpu_torch import bench_mask_pool as bench

    cs = _chip_smoke()
    assert bench.MASK_CALLS == cs.MASK_CALLS
    assert bench.POOL_SHAPES == cs.POOL_SHAPES
    assert bench.RATE == cs.MM_RATE
    assert sum(n for _, n in bench.calls_of("14")) == \
        cs.MM_STEP_LAUNCHES[cs.MASK] == 28
    assert sum(n for _, n in bench.calls_of("16")) == \
        cs.MM_STEP_LAUNCHES[cs.POOL] == 2


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", [(12544, 512), (12544, 4096), (25088, 512),
                                   (25088, 4096), (7, 13)])
def test_bench_mask_cost_equals_chip_smokes(shape, itemsize):
    from gdl_tpu_torch import bench_mask_pool as bench

    numel = shape[0] * shape[1]
    assert bench.mask_cost(numel, itemsize) == \
        _chip_smoke().mask_cost(numel, itemsize)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", [(64, 112, 112, 64), (64, 129, 94, 64),
                                   (3, 8, 5, 3), (1, 1, 1, 4)])
def test_bench_pool_cost_equals_chip_smokes(shape, itemsize):
    """x read and dx written once, g [B, ho, wo, C] read once: for the
    visual stem 2 * 51,380,224 + 12,845,056 elements."""
    from gdl_tpu_torch import bench_mask_pool as bench

    assert bench.pool_cost(shape, itemsize) == \
        _chip_smoke().pool_cost(shape, itemsize)
    if shape == (64, 112, 112, 64):
        assert bench.pool_cost(shape, itemsize) == (
            (2 * 51_380_224 + 12_845_056) * itemsize, 10 * 12_845_056)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["14", "16"])
def test_bench_step_bound_is_chip_smokes_bounds_summed(kernel, dtype):
    """A step's bound is each call's chip_smoke.bound_ms summed; both are
    set by the bytes (#14's integer work is counted at the f32 rate)."""
    from gdl_tpu_torch import bench_mask_pool as bench

    cs = _chip_smoke()
    itemsize = 4 if dtype == "float32" else 2
    want = 0.0
    for shape, calls in bench.calls_of(kernel):
        if kernel == "14":
            cost = cs.mask_cost(shape[0] * shape[1], itemsize)
        else:
            cost = cs.pool_cost(shape, itemsize)
        ms, by = cs.bound_ms(*cost)
        assert by == "bytes"
        want += calls * ms
    assert bench.step_bound(kernel, dtype) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_mask_calls_on_cpu_tensors(dtype):
    """On CPU seed words the kernel call is the plain version (the same
    bits), and the library call gives a mask of the same values and shape
    with about the same keep rate."""
    from gdl_tpu_torch import bench_mask_pool as bench

    dt = getattr(torch, dtype)
    kernel, plain, library = bench.mask_calls((256, 64), dt,
                                              torch.device("cpu"), 3)
    got, want, lib = kernel(), plain(), library()
    assert torch.equal(got, want)
    kept = torch.tensor(1.0 / 0.9).to(dt)
    for m in (got, lib):
        assert m.shape == (256, 64) and m.dtype == dt
        assert set(m.unique().tolist()) <= {0.0, float(kept)}
        assert abs(float((m != 0).float().mean()) - 0.9) < 0.02


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_pool_calls_on_cpu_tensors(dtype):
    """On CPU tensors the kernel call is the plain version, and the
    library call (aten's backward on the NCHW views, with the forward's
    indices) gives the same dx within 4 eps of the magnitude it sums."""
    from gdl_tpu_torch import bench_mask_pool as bench

    dt = getattr(torch, dtype)
    kernel, plain, library = bench.pool_calls((2, 9, 7, 8), dt,
                                              torch.device("cpu"), 4)
    got, want = kernel(), plain()
    lib = library().permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    assert got.shape == lib.shape == (2, 9, 7, 8)
    err = (got.float() - lib.float()).abs()
    assert float(err.max()) <= 4 * torch.finfo(dt).eps * float(
        got.float().abs().max())
