"""The tools around kernel #3 that run on the CPU: the profiler's kinds of
#3's three launches (its attention stage and its two instantiations of
the GEMM tile) against #4's and #13's, bench_wa_bwd's refusal without a
card and its bookkeeping, and the ctypes argument lists of the training
library against the C entry points of its source."""

import re
import subprocess
import sys

import pytest

from gdl_tpu_torch import kernels

K3 = "window_attention_bwd_fused (#3)"
K4 = "window_attention_bwd (#4)"
K13 = "self_attention (#10, #12, #13)"


@pytest.mark.parametrize("symbol,kind", [
    ("void (anonymous namespace)::wa_bwd_fused_attn_kernel<__nv_bfloat16, "
     "32>((anonymous namespace)::BwdArgs)", K3),
    ("void (anonymous namespace)::wa_bwd_fused_attn_kernel<float, 64>("
     "(anonymous namespace)::BwdArgs)", K3),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<__nv_bfloat16, "
     "128, wa3::Dx, gemm::(anonymous namespace)::KInner, gemm::(anonymous "
     "namespace)::KOuter, gemm::(anonymous namespace)::RoundT>(gemm::"
     "(anonymous namespace)::Args, wa3::Dx)", K3),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<float, 64, "
     "wa3::Dx, gemm::(anonymous namespace)::KInner, gemm::(anonymous "
     "namespace)::KOuter, gemm::(anonymous namespace)::RoundT>(gemm::"
     "(anonymous namespace)::Args, wa3::Dx)", K3),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<__nv_bfloat16, "
     "128, wa3::DwPart, gemm::(anonymous namespace)::KOuter, "
     "gemm::(anonymous namespace)::KOuter, gemm::(anonymous namespace)::"
     "F32Partial>(gemm::(anonymous namespace)::Args, wa3::DwPart)", K3),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<float, 128, "
     "wa3::DwPart, gemm::(anonymous namespace)::KOuter, gemm::(anonymous "
     "namespace)::KOuter, gemm::(anonymous namespace)::F32Partial>(gemm::"
     "(anonymous namespace)::Args, wa3::DwPart)", K3),
    # #4 and #4-delta keep their own kernel and row; #13's projection keeps
    # the identity epilogue and its row
    ("void (anonymous namespace)::wa_bwd_kernel<__nv_bfloat16, 32, false>("
     "(anonymous namespace)::BwdArgs)", K4),
    ("void (anonymous namespace)::wa_bwd_kernel<float, 64, true>("
     "(anonymous namespace)::BwdArgs)", K4),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<float, 128, "
     "gemm::(anonymous namespace)::Identity, gemm::(anonymous namespace)::"
     "KInner, gemm::(anonymous namespace)::KInner, gemm::(anonymous "
     "namespace)::RoundT>(gemm::(anonymous namespace)::Args, "
     "gemm::(anonymous namespace)::Identity)", K13),
])
def test_profile_kinds_file_kernel_3_under_3(symbol, kind):
    """#3's attention stage and its dx and dW products are filed under #3,
    not under #4 (whose kernel name the stage shares a prefix with) nor
    #13 (whose GEMM tile the products share)."""
    from gdl_tpu_torch.profile_step import kind_of

    assert kind_of(symbol) == kind


def test_kernel_3_row_comes_before_the_rows_it_overlaps():
    """The kinds are matched first row first: #3's row has to come ahead
    of #13's (gemm_tile_kernel) and #4's (wa_bwd_kernel) and #15's."""
    from gdl_tpu_torch.profile_step import KINDS

    names = [kind for kind, _ in KINDS]
    assert names.index(K3) == 0
    assert names.index(K3) < names.index(K13) and names.index(K3) < \
        names.index(K4)


def test_bench_wa_bwd_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m",
                           "gdl_tpu_torch.bench_wa_bwd"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_bench_wa_bwd_counts_the_48_calls_of_a_step():
    """2 encoders x depth (2, 2, 18, 2): 48 calls, half of the first
    three stages' shifted, none of stage 3's (its window covers the
    map)."""
    from gdl_tpu_torch.bench_wa_bwd import STAGES, calls_per_step

    per = {s: calls_per_step(depth, shape[3])
           for s, (shape, depth) in STAGES.items()}
    assert sum(sum(c.values()) for c in per.values()) == 48
    assert per["stage2"] == {False: 18, True: 18}
    assert per["stage3"] == {False: 4}


@pytest.mark.parametrize("symbol,part", [
    ("void (anonymous namespace)::wa_bwd_fused_attn_kernel<float, 32>()",
     "attention"),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<float, 64, "
     "wa3::Dx>()", "dx"),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<float, 128, "
     "wa3::DwPart>()", "dw"),
    ("void at::native::reduce_kernel<512, 1>()", "sums"),
    ("void (anonymous namespace)::wa_bwd_fused_kernel<float, 32, 256>()",
     "fused"),
])
def test_bench_wa_bwd_splits_kernel_3_by_stage(symbol, part):
    from gdl_tpu_torch.bench_wa_bwd import wa_bwd_part

    assert wa_bwd_part(symbol) == part


def test_bench_wa_bwd_cost_counts_the_function():
    """The bound's bytes and operations are the function's at a stage
    shape (the dqkv round trip is beside it, not in it)."""
    from gdl_tpu_torch.bench_wa_bwd import N, cost

    bw, c, heads = 128, 512, 16
    nbytes, ops, rt = cost(bw, c, heads, 2)
    tokens = bw * N * c
    assert ops == 8 * bw * N * N * c + 6 * bw * heads * N * N \
        + 12 * bw * N * c * c
    assert nbytes == (6 * tokens + bw * heads * N * N + 6 * c * c
                      + 3 * c) * 2 + heads * N * N * 4
    assert rt == 3 * bw * N * 3 * c * 2


def _entry_points(source: str) -> dict:
    """name -> number of parameters of each `extern "C"` function."""
    found = {}
    for m in re.finditer(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)',
                         source):
        params = [p for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = len(params)
    return found


_TRAIN_SOURCE, _TRAIN_ENTRIES = kernels.LIBRARIES["window_attention_train"]


@pytest.mark.parametrize("entry", sorted(_TRAIN_ENTRIES))
def test_train_library_argtypes_match_its_entry_points(entry):
    """Each entry point of the training library (#2 to #7, #3's three
    launches) takes as many parameters as its ctypes argtypes; #3's takes
    the dqkv workspace."""
    found = _entry_points((kernels.KERNEL_DIR / _TRAIN_SOURCE).read_text())
    assert set(found) == set(_TRAIN_ENTRIES)
    assert found[entry] == len(_TRAIN_ENTRIES[entry][0])


def test_first_design_of_kernel_3_is_gone():
    """#3 is the three-launch design alone: the first design's fused
    kernel, its shared-memory layout and column-tile dispatch, and the
    Python tiling rule are deleted; the new entry takes the workspace."""
    from gdl_tpu_torch.ops import window_attention as wa

    source = (kernels.KERNEL_DIR / _TRAIN_SOURCE).read_text()
    for gone in ("wa_bwd_fused_kernel", "FusedSmem", "kGK",
                 "dispatch_bwd_fused"):
        assert gone not in source, gone
    assert "wa_bwd_fused_attn_kernel" in source and "wa3::products" in source
    assert not hasattr(wa, "_fused_bwd_tiling")
    assert not hasattr(wa, "_FUSED_BWD_TARGET_BLOCKS")


def test_kernel_3_has_one_entry_and_shares_4s_body():
    """#3 is reached through its one entry point alone (no entry, wrapper
    or launch counter for its products by themselves), and its attention
    stage and #4 are two kernels on one device body, #3's with the db sum
    switched on."""
    from gdl_tpu_torch.ops import window_attention as wa

    source = (kernels.KERNEL_DIR / _TRAIN_SOURCE).read_text()
    assert "products_launch" not in source
    assert not any("products" in e for e in _TRAIN_ENTRIES)
    assert not any("products" in k for k in kernels.launch_counts)
    assert not hasattr(wa, "_launch_bwd_products")
    assert source.count("bwd_windows<T, DMAX, DELTA, false, false>(") == 1
    assert source.count("bwd_windows<T, DMAX, false, false, true>(") == 1


def test_kernel_3_launcher_refuses_cpu_tensors():
    """#3's launcher takes CUDA tensors only: on the CPU it raises, and
    the op's plain version is what runs there."""
    import torch

    from gdl_tpu_torch.ops import window_attention as wa

    bw, n, c, heads = 2, 4, 8, 2
    qkv, dout, x = (torch.zeros(bw, n, 3 * c), torch.zeros(bw, n, c),
                    torch.zeros(bw, n, c))
    p = torch.full((bw, heads, n, n), 1.0 / n)
    w = torch.zeros(3 * c, c)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        wa._launch_bwd_fused_parts(qkv, p, dout, x, w, heads, 0.5)
    dx, dw, db, dbias = wa.window_attention_qkv_fused_bwd_fused(
        qkv, p, dout, x, w, heads)
    assert kernels.launch_counts == before
    assert tuple(dx.shape) == (bw, n, c) and tuple(dw.shape) == (3 * c, c)
    assert tuple(db.shape) == (3 * c,) and tuple(dbias.shape) == (heads, n, n)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("kernel", ["4", "4_delta", "6", "7", "3"])
def test_bench_wa_attn_bwd_cost_equals_chip_smokes(kernel, itemsize):
    """The backward timing tool bounds each kernel at every site of a
    batch-32 Swin-B pass with chip_smoke.py's count of bytes and
    operations, and its pass bound is chip_smoke's per_pass_bound."""
    from gdl_tpu_torch import bench_wa_attn_bwd as bench

    cs = _chip_smoke()
    kind = bench.KINDS[kernel]
    seen = 0
    for _, bw, c, heads, res, masked, calls in bench.sites():
        assert bench.cost(kind, bw, c, heads, masked, res, itemsize) == \
            cs.attention_cost(kind, bw, c, heads, masked, res, itemsize)
        seen += calls
    assert seen == 48
    dtype = "float32" if itemsize == 4 else "bfloat16"
    want = cs.per_pass_bound(kind, bench.BATCH, dtype)["ms"]
    assert bench.pass_bound(kernel, dtype) == pytest.approx(want, rel=1e-12)


def test_bench_wa_attn_bwd_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m",
                           "gdl_tpu_torch.bench_wa_attn_bwd"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("symbol,part", [
    ("void (anonymous namespace)::wa_bwd_kernel<float, 32, false>("
     "(anonymous namespace)::BwdArgs)", "body"),
    ("void (anonymous namespace)::wa_bwd_rows_kernel<__nv_bfloat16, 32>("
     "(anonymous namespace)::BwdArgs)", "body"),
    ("void (anonymous namespace)::wa_bwd_recompute_kernel<float, 64>("
     "(anonymous namespace)::BwdArgs)", "body"),
    ("void (anonymous namespace)::wa_bwd_fused_attn_kernel<float, 32>("
     "(anonymous namespace)::BwdArgs)", "body"),
    ("void gemm::(anonymous namespace)::gemm_tile_kernel<float, 128, "
     "wa3::DwPart>()", "products"),
    ("void at::native::reduce_kernel<512, 1>()", "sums"),
])
def test_bench_wa_attn_bwd_splits_by_part(symbol, part):
    from gdl_tpu_torch.bench_wa_attn_bwd import body_part

    assert body_part(symbol) == part


def test_simt_attention_backward_body_is_gone():
    """The first design's backward body (attn_bwd_tile on f32 shared
    memory, BwdSmem) is deleted; the five backward kernels (#4, #4-delta,
    #3's stage A, #6's and #7's backward) are bwd_windows of the new
    header, with a mode each."""
    source = (kernels.KERNEL_DIR / _TRAIN_SOURCE).read_text()
    body = (kernels.KERNEL_DIR / "window_attention_bwd.cuh").read_text()
    for gone in ("attn_bwd_tile", "BwdSmem", "store_dqkv", "zero16"):
        assert gone not in source and gone not in body, gone
    assert '#include "window_attention_bwd.cuh"' in source
    for call in ("bwd_windows<T, DMAX, DELTA, false, false>(a)",
                 "bwd_windows<T, DMAX, false, false, true>(a)",
                 "bwd_windows<T, DMAX, false, true, false>(a)",
                 "bwd_windows<T, DMAX, false, false, false>(a)"):
        assert source.count(call) == 1, call
    assert "mma_bf16" in body and "ldsm_x4_trans" in body
