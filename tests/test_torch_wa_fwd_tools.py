"""The tools around kernels #2 and #1 that run on the CPU: the profiler's
kinds of their projection (the GEMM tile with the wa2::ProjBias epilogue)
against the tile's other instantiations, bench_wa_fwd's arguments, its
refusal without a card, its bookkeeping and its bound against
chip_smoke.py's, the eval library's ctypes arguments, and the removal of
the first design's in-kernel projection."""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gdl_tpu_torch import kernels
from test_torch_mlp_tools import _entry_points

REPO = Path(__file__).resolve().parents[1]
PROJ = "window_attention_proj (#1, #2)"
ATTN = "window_attention (#1, #2, #5, #7 forward)"
SA = "self_attention (#10, #12, #13)"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tile(dtype: str, bm: int, epi: str) -> str:
    a = "gemm::(anonymous namespace)::"
    return (f"void {a}gemm_tile_kernel<{dtype}, {bm}, {epi}, {a}KInner, "
            f"{a}KInner, {a}RoundT>({a}Args, {epi})")


@pytest.mark.parametrize("symbol,kind", [
    (_tile("__nv_bfloat16", 128, "wa2::(anonymous namespace)::ProjBias<"
           "__nv_bfloat16>"), PROJ),
    (_tile("__nv_bfloat16", 64, "wa2::(anonymous namespace)::ProjBias<"
           "__nv_bfloat16>"), PROJ),
    (_tile("float", 128, "wa2::(anonymous namespace)::ProjBias<float>"),
     PROJ),
    (_tile("float", 64, "wa2::(anonymous namespace)::ProjBias<float>"),
     PROJ),
    # the attention launch of #1 and #2 (#7's and #5's kernel)
    ("void (anonymous namespace)::wa_fwd_kernel<float, 32, true>(float "
     "const*, float const*, float const*, float*, float*, int, int, int, "
     "int, int, float)", ATTN),
    ("void (anonymous namespace)::wa_fwd_kernel<__nv_bfloat16, 64, false>("
     "__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, "
     "__nv_bfloat16*, int, int, int, int, int, float)", ATTN),
    # the tile's other instantiations keep their rows
    (_tile("float", 128, "gemm::(anonymous namespace)::Identity"), SA),
    (_tile("__nv_bfloat16", 128, "mlp::Fc2Bias<__nv_bfloat16>"),
     "mlp_fused (#15)"),
    (_tile("float", 64, "wa3::Dx"), "window_attention_bwd_fused (#3)"),
])
def test_profile_kinds_tell_the_projection_of_1_and_2_apart(symbol, kind):
    """#1's and #2's projection is filed under its own row, not under the
    self-attention row that takes the identity instantiation."""
    from gdl_tpu_torch.profile_step import kind_of

    assert kind_of(symbol) == kind


def test_projection_row_comes_before_the_self_attention_row():
    from gdl_tpu_torch.profile_step import KINDS

    names = [kind for kind, _ in KINDS]
    assert names.index(PROJ) < names.index(SA)


def test_bench_wa_fwd_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m",
                           "gdl_tpu_torch.bench_wa_fwd", "--roots", "a", "b",
                           "--out", "never.json"],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
    assert not (REPO / "never.json").exists()


@pytest.mark.parametrize("argv,bad", [
    (["--roots"], False), (["--roots", "p", ".", ".", "p"], False),
    (["--out", "x.json"], False), (["--worker"], False),
    (["--bogus"], True), (["--out"], True)])
def test_bench_wa_fwd_parses_its_arguments(argv, bad, monkeypatch):
    """Unknown options and a missing value are refused by argparse (exit
    2 before anything else); a valid command line gets past parsing to
    the card check, which refuses here with 2 and prints no result."""
    import torch

    from gdl_tpu_torch import bench_wa_fwd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if bad:
        with pytest.raises(SystemExit) as e:
            bench_wa_fwd.main(argv)
        assert e.value.code == 2
    else:
        assert bench_wa_fwd.main(argv) == 2


@pytest.mark.parametrize("kind", ["savep", "eval"])
def test_bench_wa_fwd_counts_the_48_calls_of_a_pass(kind):
    """2 encoders x depth (2, 2, 18, 2): 48 calls, half of the first
    three stages' shifted, none of stage 3's; #2 at the batch-32 window
    counts, #1 at the batch-16 ones."""
    from gdl_tpu_torch.bench_wa_fwd import sites

    got = list(sites(kind))
    assert sum(s[-1] for s in got) == 48
    assert sum(s[-1] for s in got if s[5]) == 22
    bws = {s[0]: s[1] for s in got}
    scale = 2 if kind == "savep" else 1
    assert bws == {"stage0": 1024 * scale, "stage1": 256 * scale,
                   "stage2": 64 * scale, "stage3": 16 * scale}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,batch", [("savep", 32), ("eval", 16)])
def test_bench_wa_fwd_bound_is_chip_smokes(kind, batch, dtype):
    """The bound bench_wa_fwd reports for a pass is chip_smoke.py's
    per_pass_bound for the same kernel and batch, call by call: the same
    bytes and operations at every site."""
    from gdl_tpu_torch.bench_wa_fwd import cost, pass_bound, sites

    cs = _chip_smoke()
    itemsize = 4 if dtype == "float32" else 2
    for _, bw, c, heads, res, masked, _ in sites(kind):
        assert cost(kind, bw, c, heads, masked, res, itemsize)[:2] == \
            cs.attention_cost(kind, bw, c, heads, masked, res, itemsize)
    got, want = pass_bound(kind, dtype), cs.per_pass_bound(kind, batch, dtype)
    assert got["bound_ms"] == pytest.approx(want["ms"], rel=1e-12)
    assert got["bytes"] == want["bytes"]
    assert got["operations"] == want["operations"]


def test_bench_wa_fwd_split_bytes_are_the_qkv_round_trip():
    """Beside the bound: #2 reads its qkv [Bw, N, 3C] back once, #1
    writes and reads it; the bound counts neither."""
    from gdl_tpu_torch.bench_wa_fwd import N, cost

    bw, c, heads = 128, 512, 16
    for kind, times in (("savep", 1), ("eval", 2)):
        nbytes, ops, split = cost(kind, bw, c, heads, True, 14, 2)
        assert split == times * bw * N * 3 * c * 2
        assert ops == 2 * bw * N * c * 3 * c + 4 * bw * N * N * c \
            + 5 * bw * heads * N * N
    without = cost("eval", bw, c, heads, False, 14, 2)[0]
    assert cost("eval", bw, c, heads, True, 14, 2)[0] - without == \
        4 * N * N * 4  # the mask: 4 windows of a 14 x 14 map


@pytest.mark.parametrize("symbol,part", [
    (_tile("float", 128, "wa2::(anonymous namespace)::ProjBias<float>"),
     "projection"),
    ("void (anonymous namespace)::wa_fwd_kernel<float, 32, true>(float "
     "const*)", "attention"),
    ("void (anonymous namespace)::wa_fwd_kernel<__nv_bfloat16, 64, false>("
     "__nv_bfloat16 const*)", "attention"),
    # the first design's one kernel, PROJ its fourth template argument
    ("void (anonymous namespace)::wa_fwd_kernel<float, 32, true, true>("
     "float const*)", "fused"),
    ("void (anonymous namespace)::wa_fwd_kernel<__nv_bfloat16, 16, false, "
     "true>(__nv_bfloat16 const*)", "fused"),
    # ... and with PROJ false, the attention on a given qkv
    ("void (anonymous namespace)::wa_fwd_kernel<float, 32, true, false>("
     "float const*)", "attention"),
    ("void at::native::elementwise_kernel<128, 2>()", "other"),
])
def test_bench_wa_fwd_splits_the_kernels_by_part(symbol, part):
    from gdl_tpu_torch.bench_wa_fwd import wa_fwd_part

    assert wa_fwd_part(symbol) == part


def test_eval_entry_takes_the_qkv_workspace():
    """#1's entry point takes the qkv workspace after the mask (and the
    attention's windows per block after nW), as its ctypes argtypes and
    the op wrapper pass it."""
    source_file, entries = kernels.LIBRARIES["window_attention_eval"]
    source = (kernels.KERNEL_DIR / source_file).read_text()
    assert _entry_points(source) == {"gdl_wa_eval_launch": 17}
    assert re.search(r"int nw, int wpb,\s+float scale", source)
    assert entries["gdl_wa_eval_launch"][0][:7] == [kernels._vp] * 7
    assert re.search(r"const void\* mask,\s+void\* qkv, void\* out", source)


@pytest.mark.parametrize("source", ["window_attention_eval.cu",
                                    "window_attention_train.cu"])
def test_forward_entries_project_then_run_the_attention_body(source):
    """#1's and #2's entries make two launches: wa2::project into qkv,
    then dispatch_fwd on it (#7's forward for #1, #5's for #2)."""
    text = (kernels.KERNEL_DIR / source).read_text()
    assert "window_attention_proj.cuh" in text
    assert text.count("wa2::project<T>(x, w, b, qkv, bw * n, c, s)") == 1
    save = "true" if "train" in source else "false"
    assert f"dispatch_fwd<T, {save}>(qkv, bias, mask, out" in text


def test_projection_epilogue_rounds_then_adds_the_bias():
    """wa2::ProjBias is round_T(v) + b[col] in an unnamed namespace inside
    wa2, and the projection takes gemm::row_tile's row tile."""
    text = (kernels.KERNEL_DIR / "window_attention_proj.cuh").read_text()
    assert re.search(r"namespace wa2 \{\s*//[^\n]*\nnamespace \{", text)
    assert "return Num<T>::round(v) + Num<T>::load(bias + col);" in text
    assert "gemm::row_tile<T>(tokens, 3 * c, &bm)" in text


def test_first_design_of_kernels_1_and_2_is_gone():
    """The in-kernel projection of the forward header is deleted: no PROJ
    branch or template parameter, no projection layout, no C-chunk width;
    every forward kernel reads a qkv in device memory (dispatch_fwd points
    the body's q, k and v at it)."""
    text = (kernels.KERNEL_DIR / "window_attention_fwd.cuh").read_text()
    code = "\n".join(ln.split("//")[0] for ln in text.splitlines())
    for gone in ("PROJ", "kProj", "kLdX", "kKC", "kUnion", "xs[", "ws["):
        assert gone not in code, gone
    assert "wa_fwd_kernel(FwdArgs a)" in code
    assert "const T* q = static_cast<const T*>(qkv);" in code
    for name in ("window_attention_bhnd.cu", "window_attention_train.cu"):
        body = (kernels.KERNEL_DIR / name).read_text()
        assert "kUnion" not in body and "PROJ=" not in body, name


def test_projection_launchers_refuse_cpu_tensors():
    """#1's and #2's launchers take CUDA tensors only: on the CPU they
    raise, and the ops' plain versions run there without a count."""
    import torch

    from gdl_tpu_torch.ops import window_attention as wa

    bw, n, c, heads = 2, 4, 8, 2
    x, w, b = torch.zeros(bw, n, c), torch.zeros(3 * c, c), torch.zeros(3 * c)
    bias = torch.zeros(heads, n, n)
    before = dict(kernels.launch_counts)
    for launch in (wa._launch, wa._launch_savep):
        with pytest.raises(ValueError, match="CUDA"):
            launch(x, w, b, bias, None, heads, 0.5)
    out = wa.window_attention_qkv_fused_eval(x, w, b, bias, None, heads)
    o2, qkv, p = wa.window_attention_qkv_fused_fwd(x, w, b, bias, None, heads)
    assert kernels.launch_counts == before
    assert tuple(out.shape) == (bw, n, c) and torch.equal(out, o2)
    assert tuple(qkv.shape) == (bw, n, 3 * c)
    assert tuple(p.shape) == (bw, heads, n, n)
