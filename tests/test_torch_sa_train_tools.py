"""The tools around kernels #10 and #12 that run on the CPU: the
profiler's kinds of the training forward's symbols (its row tile and the
GEMM tile's identity instantiation under the self-attention row, #15's
epilogues under #15), bench_sa_train's refusal without a card, and the
kernel sources of the training forward."""

import subprocess
import sys

import pytest

from gdl_tpu_torch import kernels

SA_KIND = "self_attention (#10, #11, #12, #13)"
MLP_KIND = "mlp_fused (#15)"
ANON = "(anonymous namespace)"


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
    (f"void {ANON}::sa_tile_kernel<float, 64>({ANON}::SaArgs)", SA_KIND),
    (f"void {ANON}::sa_bwd_kv_kernel<__nv_bfloat16, 64>({ANON}::SaArgs)",
     SA_KIND),
    (f"void gemm::{ANON}::gemm_tile_kernel<float, 128, mlp::Fc1Gelu<float> >"
     f"(gemm::{ANON}::Args, mlp::Fc1Gelu<float>)", MLP_KIND),
    (f"void gemm::{ANON}::gemm_tile_kernel<__nv_bfloat16, 64, "
     f"mlp::Fc2Bias<__nv_bfloat16> >(gemm::{ANON}::Args, "
     f"mlp::Fc2Bias<__nv_bfloat16>)", MLP_KIND),
])
def test_profile_kinds_file_the_training_forward(symbol, kind):
    """#10's projection (the tile's identity instantiation) and the row
    tile of #10 / #12 are filed under the self-attention row; #15's
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
    """The training forward has no SIMT projection and no forward mode of
    the backward's row tile: part A serves only the backward."""
    text = {p.name: p.read_text() for p in kernels.KERNEL_DIR.glob("*.cu*")}
    for name, src in text.items():
        assert "sa_proj_kernel<" not in src, name
        assert "MODE_TRAIN" not in src, name
    assert "sa_tile_kernel<T, DMAX><<<" in text["self_attention_fwd.cuh"]


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
