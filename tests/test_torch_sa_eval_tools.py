"""The tools around kernel #13 that run on the CPU: the profiler's kinds
of its new kernel symbols, and bench_sa_eval's refusal without a card."""

import subprocess
import sys

import pytest


@pytest.mark.parametrize("symbol", [
    "void sa_eval::sa_eval_kernel<float, 64, 64>(sa_eval::Args)",
    "void sa_eval::sa_eval_kernel<__nv_bfloat16, 128, 32>(sa_eval::Args)",
    "void gemm::gemm_tile_kernel<__nv_bfloat16>(gemm::Args)",
    "void gemm::gemm_tile_kernel<float>(gemm::Args)",
])
def test_profile_kinds_file_the_eval_kernels_under_self_attention(symbol):
    from gdl_tpu_torch.profile_step import kind_of

    assert "#13" in kind_of(symbol), kind_of(symbol)


def test_bench_sa_eval_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m", "gdl_tpu_torch.bench_sa_eval"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
