"""The tools around kernels #10, #12 and #11 that run on the CPU: the
profiler's kinds of their symbols (the forwards' row tile and the GEMM
tile's identity instantiation under the self-attention row, #11's two
launches under a row of their own, #15's epilogues under #15),
bench_sa_train's refusal without a card, its split and cost of #11, and
the kernel sources of the training kernels."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from gdl_tpu_torch import kernels

SA_KIND = "self_attention (#10, #12, #13)"
BWD_KIND = "self_attention_bwd (#11)"
MLP_KIND = "mlp_fused (#15)"
ANON = "(anonymous namespace)"
REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("symbol,kind", [
    (f"void sa_rows::{ANON}::sa_train_kernel<__nv_bfloat16, 64, 64>"
     f"(sa_rows::{ANON}::Args)", SA_KIND),
    (f"void sa_rows::{ANON}::sa_train_kernel<float, 128, 32>"
     f"(sa_rows::{ANON}::Args)", SA_KIND),
    (f"void sa_rows::{ANON}::sa_eval_kernel<float, 64, 64>"
     f"(sa_rows::{ANON}::Args)", SA_KIND),
    (f"void gemm::{ANON}::gemm_tile_kernel<__nv_bfloat16, 128, "
     f"gemm::{ANON}::Identity>(gemm::{ANON}::Args, gemm::{ANON}::Identity)",
     SA_KIND),
    (f"void gemm::{ANON}::gemm_tile_kernel<float, 128, "
     f"gemm::{ANON}::Identity>(gemm::{ANON}::Args, gemm::{ANON}::Identity)",
     SA_KIND),
    (f"void sa_rows::{ANON}::sa_bwd_rows_kernel<float, 64, 64>"
     f"(sa_rows::{ANON}::Args)", BWD_KIND),
    (f"void sa_keys::{ANON}::sa_bwd_keys_kernel<__nv_bfloat16, 64>"
     f"(sa_rows::{ANON}::Args, int)", BWD_KIND),
    (f"void gemm::{ANON}::gemm_tile_kernel<float, 128, mlp::Fc1Gelu<float> >"
     f"(gemm::{ANON}::Args, mlp::Fc1Gelu<float>)", MLP_KIND),
    (f"void gemm::{ANON}::gemm_tile_kernel<__nv_bfloat16, 64, "
     f"mlp::Fc2Bias<__nv_bfloat16> >(gemm::{ANON}::Args, "
     f"mlp::Fc2Bias<__nv_bfloat16>)", MLP_KIND),
])
def test_profile_kinds_file_the_training_forward(symbol, kind):
    """#10's projection (the tile's identity instantiation) and the row
    tile of #10 / #12 are filed under the self-attention row, #11's part
    A (the row tile's backward mode) and part B under #11's own; #15's
    instantiations of the same tile stay under #15."""
    from gdl_tpu_torch.profile_step import kind_of

    assert kind_of(symbol) == kind


def test_bench_sa_train_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m",
                           "gdl_tpu_torch.bench_sa_train"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("library", ["self_attention_train",
                                     "self_attention_eval"])
def test_both_forwards_share_the_row_tile(library):
    """#10 / #12 and #13 include the one row tile and the one GEMM tile,
    so an edit of either rebuilds both libraries."""
    source = (kernels.KERNEL_DIR / kernels.LIBRARIES[library][0]).read_text()
    assert '#include "self_attention_rows.cuh"' in source
    assert "gemm::launch<T>" in source


def test_the_first_forward_design_is_gone():
    """Neither first-design kernel of the training path is left: no SIMT
    projection, no SIMT row tile of the backward (sa_tile_kernel, its
    header self_attention_fwd.cuh) and no SIMT key kernel
    (sa_bwd_kv_kernel). #11 launches the row tile's backward mode and the
    tensor-core key kernel."""
    text = {p.name: p.read_text() for p in kernels.KERNEL_DIR.glob("*.cu*")}
    assert "self_attention_fwd.cuh" not in text
    for name, src in text.items():
        for gone in ("sa_proj_kernel<", "MODE_TRAIN", "sa_tile_kernel",
                     "sa_bwd_kv_kernel", "self_attention_fwd.cuh"):
            assert gone not in src, (name, gone)
    train = text["self_attention_train.cu"]
    assert "sa_rows::launch_attention<T, sa_rows::kBwd>" in train
    assert "sa_bwd_keys_kernel<T, DMAX><<<" in train


@pytest.mark.parametrize("name,part", [
    (f"void sa_rows::{ANON}::sa_bwd_rows_kernel<__nv_bfloat16, 64, 64>"
     f"(sa_rows::{ANON}::Args)", "part_a"),
    (f"void sa_keys::{ANON}::sa_bwd_keys_kernel<float, 64>"
     f"(sa_rows::{ANON}::Args, int)", "part_b"),
    (f"void {ANON}::sa_tile_kernel<float, 64>({ANON}::SaArgs)", "part_a"),
    (f"void {ANON}::sa_bwd_kv_kernel<__nv_bfloat16, 64>({ANON}::SaArgs)",
     "part_b"),
])
def test_bench_files_the_backward_split(name, part):
    """bench_sa_train's profiler split of #11 files the key kernel as
    part B and the row kernel as part A, in this design and in the first
    (a parent checkout timed in turns)."""
    from gdl_tpu_torch.bench_sa_train import _bwd_part

    assert _bwd_part(name) == part


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("itemsize,bound_by", [(4, "operations"),
                                               (2, "bytes")])
def test_bench_backward_cost(itemsize, bound_by):
    """bench_sa_train's cost of #11 is chip_smoke.py's, site by site; over
    a step (4 launches at N = 196, 3 at 392) it is bound by operations in
    f32 (2.433 ms at 67 TFLOP/s) and by bytes in bf16 (0.456 ms); the ds
    round trip is two score-sized passes in T."""
    from gdl_tpu_torch.bench_sa_train import SITES, bwd_cost

    cs = _chip_smoke()
    dtype = "float32" if itemsize == 4 else "bfloat16"
    step = 0.0
    for (b, n, c), calls in SITES.values():
        got = bwd_cost(b, n, c, 8, itemsize)
        nbytes, ops = cs.sa_cost("bwd", b, n, c, 8, itemsize)
        assert (got["bytes"], got["operations"]) == (nbytes, ops)
        assert got["bound_ms"] == pytest.approx(
            cs.bound_ms(nbytes, ops, dtype)[0], rel=1e-12)
        assert got["bound_by"] == bound_by
        assert got["ds_round_trip_bytes"] == 2 * b * 8 * n * n * itemsize
        step += calls * got["bound_ms"]
    assert step == pytest.approx(2.433 if itemsize == 4 else 0.456,
                                 abs=5e-4)


@pytest.mark.parametrize("n,itemsize,per_sm", [
    (16, 2, 2), (196, 2, 2), (392, 2, 1), (196, 4, 1), (392, 4, 1)])
def test_bench_residency_model(n, itemsize, per_sm):
    """bench_sa_train's count of resident blocks follows ring_depth's
    rule: two bf16 blocks an SM while the tile and four chunk buffers fit
    in half an SM's shared memory, one f32 block (its registers)."""
    from gdl_tpu_torch.bench_sa_train import _resident_blocks

    got = _resident_blocks(n, itemsize)
    assert got["per_sm"] == per_sm
    assert got["row_blocks"] == (n + 63) // 64
    assert got["resident"] == 132 * per_sm
