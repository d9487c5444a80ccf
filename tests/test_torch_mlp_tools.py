"""The tools around kernel #15 that run on the CPU: the profiler's kinds of
the GEMM tile's instantiations (#15's fc1 and fc2 against #13's
projection), bench_mlp's refusal without a card, and the ctypes argument
lists of every kernel library against the C entry points of its source."""

import re
import subprocess
import sys

import pytest

from gdl_tpu_torch import kernels

MLP_KIND = "mlp_fused (#15)"


@pytest.mark.parametrize("symbol,kind", [
    ("void gemm::gemm_tile_kernel<__nv_bfloat16, 128, "
     "mlp::Fc1Gelu<__nv_bfloat16> >(gemm::Args, "
     "mlp::Fc1Gelu<__nv_bfloat16>)", MLP_KIND),
    ("void gemm::gemm_tile_kernel<__nv_bfloat16, 64, "
     "mlp::Fc2Bias<__nv_bfloat16> >(gemm::Args, "
     "mlp::Fc2Bias<__nv_bfloat16>)", MLP_KIND),
    ("void gemm::gemm_tile_kernel<float, 128, mlp::Fc1Gelu<float> >"
     "(gemm::Args, mlp::Fc1Gelu<float>)", MLP_KIND),
    ("void gemm::gemm_tile_kernel<float, 64, mlp::Fc2Bias<float> >"
     "(gemm::Args, mlp::Fc2Bias<float>)", MLP_KIND),
    ("void gemm::gemm_tile_kernel<__nv_bfloat16, 128, gemm::Identity>"
     "(gemm::Args, gemm::Identity)", "self_attention (#10, #12, #13)"),
    ("void gemm::gemm_tile_kernel<float, 128, gemm::Identity>"
     "(gemm::Args, gemm::Identity)", "self_attention (#10, #12, #13)"),
])
def test_profile_kinds_tell_mlp_gemms_from_the_projection(symbol, kind):
    """#15's instantiations of the shared tile (epilogues of namespace
    mlp) are filed under #15; the identity instantiation stays #13's."""
    from gdl_tpu_torch.profile_step import kind_of

    assert kind_of(symbol) == kind


def test_bench_mlp_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m", "gdl_tpu_torch.bench_mlp"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def _entry_points(source: str) -> dict:
    """name -> number of parameters of each `extern "C"` function."""
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         source):
        params = [p for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = len(params)
    return found


@pytest.mark.parametrize("library", sorted(kernels.LIBRARIES))
def test_ctypes_argtypes_match_the_c_entry_points(library):
    """Each entry point that LIBRARIES binds is an `extern "C"` function
    of the library's source with as many parameters as its argtypes: a
    pointer added on one side only would shift every later argument."""
    source_file, entries = kernels.LIBRARIES[library]
    found = _entry_points((kernels.KERNEL_DIR / source_file).read_text())
    assert set(entries) == set(found)
    for name, (argtypes, _) in entries.items():
        assert found[name] == len(argtypes), name
