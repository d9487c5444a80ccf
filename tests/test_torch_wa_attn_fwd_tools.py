"""The tools around the window-attention forward body
(kernels/window_attention_fwd.cuh: #1, #2, #5, #6's and #7's forward, #8,
#9) that run on the CPU: bench_wa_attn_fwd's refusal without a card, its
arguments, its bookkeeping and its bound against chip_smoke.py's, the
profiler's kinds of the body's kernel symbols, the removal of the first
design, the rule for the windows a block walks, and the launchers'
refusal of CPU tensors."""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gdl_tpu_torch import kernels

REPO = Path(__file__).resolve().parents[1]
ATTN = "window_attention (#1, #2, #5, #7 forward)"
BHND = "window_attention_bhnd (#8, #9)"
ANON = "(anonymous namespace)"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_wa_attn_fwd_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    proc = subprocess.run([sys.executable, "-m",
                           "gdl_tpu_torch.bench_wa_attn_fwd", "--roots", "a",
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
def test_bench_wa_attn_fwd_parses_its_arguments(argv, bad, monkeypatch):
    """Unknown options and a missing value are refused by argparse (exit
    2 before anything else); a valid command line gets past parsing to
    the card check, which refuses here with 2 and prints no result."""
    import torch

    from gdl_tpu_torch import bench_wa_attn_fwd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if bad:
        with pytest.raises(SystemExit) as e:
            bench_wa_attn_fwd.main(argv)
        assert e.value.code == 2
    else:
        assert bench_wa_attn_fwd.main(argv) == 2


@pytest.mark.parametrize("batch", [32, 16])
def test_bench_wa_attn_fwd_counts_the_48_calls_of_a_pass(batch):
    """2 encoders x depth (2, 2, 18, 2): 48 calls, 22 of them shifted,
    at the batch's window counts."""
    from gdl_tpu_torch.bench_wa_attn_fwd import sites

    got = list(sites(batch))
    assert sum(s[-1] for s in got) == 48
    assert sum(s[-1] for s in got if s[5]) == 22
    scale = batch // 16
    assert {s[0]: s[1] for s in got} == {
        "stage0": 1024 * scale, "stage1": 256 * scale, "stage2": 64 * scale,
        "stage3": 16 * scale}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("kernel", ["5", "6_fwd", "7_fwd", "8", "9", "2",
                                    "1"])
def test_bench_wa_attn_fwd_cost_equals_chip_smokes(kernel, itemsize):
    """Each forward is bounded at every site of its pass with
    chip_smoke.py's count of bytes and operations (#5 and #6's forward:
    qkv_savep; #7's forward, #8, #9: attn_fwd; #2: savep; #1: eval, at
    batch 16), and its pass bound is chip_smoke's per_pass_bound."""
    from gdl_tpu_torch import bench_wa_attn_fwd as bench

    cs = _chip_smoke()
    kind, batch = bench.KERNELS[kernel]
    seen = 0
    for _, bw, c, heads, res, masked, calls in bench.sites(batch):
        assert bench.cost(kind, bw, c, heads, masked, res, itemsize) == \
            cs.attention_cost(kind, bw, c, heads, masked, res, itemsize)
        seen += calls
    assert seen == 48
    dtype = "float32" if itemsize == 4 else "bfloat16"
    want = cs.per_pass_bound(kind, batch, dtype)["ms"]
    assert bench.pass_bound(kernel, dtype) == pytest.approx(want, rel=1e-12)


def _fwd(dtype: str, dmax: int, save: str) -> str:
    return (f"void {ANON}::wa_fwd_kernel<{dtype}, {dmax}, {save}>({ANON}::"
            f"FwdArgs)")


def _bhnd(dtype: str, dmax: int) -> str:
    return f"void {ANON}::wa_bhnd_kernel<{dtype}, {dmax}>({ANON}::FwdArgs)"


NEW_SYMBOLS = [
    # #5 and #6's forward (SAVE), #7's forward and #1's attention (no p),
    # #2's attention (#5's launch), each head-dim tiling
    (_fwd("__nv_bfloat16", 32, "true"), ATTN),
    (_fwd("float", 32, "true"), ATTN),
    (_fwd("__nv_bfloat16", 32, "false"), ATTN),
    (_fwd("float", 16, "false"), ATTN),
    (_fwd("__nv_bfloat16", 64, "true"), ATTN),
    # #8 and #9: one launch on the [B, H, N, D] strides
    (_bhnd("__nv_bfloat16", 32), BHND),
    (_bhnd("float", 64), BHND),
]


@pytest.mark.parametrize("symbol,kind", NEW_SYMBOLS)
def test_profile_kinds_file_the_forward_body(symbol, kind):
    """profile_step files the forward body's kernels (each taking the
    FwdArgs of window_attention_fwd.cuh) under the forwards' row, #6's
    forward among them since it is #5's launch, and #8's and #9's under
    theirs; none under the backward rows whose names they share a prefix
    with."""
    from gdl_tpu_torch.profile_step import kind_of

    assert kind_of(symbol) == kind


@pytest.mark.parametrize("symbol,kind", NEW_SYMBOLS)
def test_bench_splits_file_the_forward_body_as_attention(symbol, kind):
    """bench_wa_fwd's and bench_wa_attn_fwd's profiler splits of #1 and #2
    file the body's kernel as their attention."""
    from gdl_tpu_torch.bench_wa_attn_fwd import part_of
    from gdl_tpu_torch.bench_wa_fwd import wa_fwd_part

    if kind == ATTN:
        assert wa_fwd_part(symbol) == "attention"
        assert part_of(symbol) == "attention"
    else:
        assert part_of(symbol) == "other"


def _code(path: Path) -> str:
    """A source without its comments: C++ `//` comments, Python `#`
    comments (history may be recorded there)."""
    mark = "#" if path.suffix == ".py" else "//"
    return "\n".join(ln.split(mark)[0] for ln in
                     path.read_text().splitlines())


@pytest.mark.parametrize("gone", ["attn_fwd_tail", "load_head", "FwdSmem",
                                  "wa_fwd_rows_kernel", "wa_packed_kernel",
                                  "launch_fwd_rows"])
def test_first_forward_design_is_gone(gone):
    """The SIMT forward (attn_fwd_tail on f32 shared memory, its loader and
    layout) and the kernels that walked a head group (#6's forward, #9)
    appear in no kernel source, no op and no tool of the port."""
    paths = sorted(kernels.KERNEL_DIR.glob("*.cu*"))
    paths += sorted((REPO / "gdl_tpu_torch" / "ops").glob("*.py"))
    paths += [kernels.KERNEL_DIR / "__init__.py",
              REPO / "gdl_tpu_torch" / "profile_step.py"]
    for path in paths:
        assert gone not in _code(path), (path.name, gone)


def test_every_forward_entry_runs_the_one_body():
    """One forward body (fwd_windows) on the tensor cores in bf16: the
    qkv entries (#1, #2, #5, #6's and #7's forward) reach it through
    dispatch_fwd's wa_fwd_kernel, #8's and #9's through wa_bhnd_kernel;
    #7's backward takes its softmax (softmax_rows) from the same header,
    and no entry walks a head group any more."""
    kdir = kernels.KERNEL_DIR
    body = _code(kdir / "window_attention_fwd.cuh")
    assert body.count("__device__ __forceinline__ void fwd_windows(") == 1
    assert "fwd_windows<T, DMAX, SAVE>(a);" in body
    for needle in ("mma_bf16", "ldsm_x4_trans",
                   "softmax_rows<true>(s, bh, mw, ldb", "store_flat(p_w, pbuf",
                   "gemm::cp_async_ca<4>(bias_s + i * ldb + jj"):
        assert needle in body, needle
    bhnd = _code(kdir / "window_attention_bhnd.cu")
    assert "fwd_windows<T, DMAX, false>(a);" in bhnd
    assert "launch_body<T, DMAX>(wa_bhnd_kernel<T, DMAX>, a, s)" in bhnd
    train = _code(kdir / "window_attention_train.cu")
    assert "return gdl_wa_qkv_savep_launch(" in train
    assert "dispatch_fwd<T, false>(qkv, bias, mask, out, nullptr" in train
    evl = _code(kdir / "window_attention_eval.cu")
    assert "dispatch_fwd<T, false>(qkv, bias, mask, out, nullptr" in evl
    bwd = _code(kdir / "window_attention_bwd.cuh")
    assert "softmax_rows<false>(pv, bh, mw, n, n, r0, lane);" in bwd
    for name in ("window_attention_train", "window_attention_bhnd"):
        for entry, (argtypes, _) in kernels.LIBRARIES[name][1].items():
            if entry in ("gdl_wa_qkv_savep_rows_launch",
                         "gdl_wa_packed_launch"):
                # no head group g: the shape, nW and the windows a block
                assert argtypes[-5:-3] == [kernels._int] * 2, entry


@pytest.mark.parametrize("batch", [32, 16])
def test_forward_grid_is_1024_blocks_at_every_swin_b_site(batch):
    """The windows a block walks come from the shape alone and keep one
    mask class a block: at every site of a Swin-B pass the grid, heads x
    nW x ceil(ceil(Bw / nW) / wpb), is 1024 blocks (one (window, head) a
    block where there are fewer), with or without the shift mask's
    classes."""
    from gdl_tpu_torch.bench_wa_attn_fwd import sites
    from gdl_tpu_torch.ops import window_attention as wa

    for _, bw, c, heads, res, masked, _ in sites(batch):
        nw = (res // 7) ** 2 if masked else 1
        wpb = wa._fwd_windows_per_block(bw, heads)
        runs = -(-(-(-bw // nw)) // wpb)
        assert heads * nw * runs == min(1024, bw * heads), (bw, heads, nw)
    assert wa._fwd_windows_per_block(3, 2) == 1
    assert wa._fwd_windows_per_block(4096, 32) == 128


def test_forward_launchers_refuse_cpu_tensors():
    """The launchers of #5 / #6's forward, #7's forward and #8 / #9 take
    CUDA tensors only: on the CPU they raise, and the ops' plain versions
    run there without a count."""
    import torch

    from gdl_tpu_torch.ops import window_attention as wa

    bw, n, c, heads = 2, 4, 8, 2
    qkv, bias = torch.zeros(bw, n, 3 * c), torch.zeros(heads, n, n)
    q = torch.zeros(bw, heads, n, c // heads)
    before = dict(kernels.launch_counts)
    for rows in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            wa._launch_qkv_savep(qkv, bias, None, heads, 0.5, rows=rows)
    with pytest.raises(ValueError, match="CUDA"):
        wa._launch_qkv_fwd(qkv, bias, None, heads, 0.5)
    for packed in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            wa._launch_bhnd(q, q, q, bias, None, 0.5, packed)
    out, p = wa.window_attention_qkv_fwd(qkv, bias, None, heads,
                                         transposed=False)
    o8 = wa.window_attention_packed(q, q, q, bias)
    assert kernels.launch_counts == before
    assert tuple(out.shape) == (bw, n, c) and tuple(p.shape) == \
        (bw, heads, n, n)
    assert tuple(o8.shape) == tuple(q.shape)


@pytest.mark.parametrize("entry", ["gdl_wa_eval_launch",
                                   "gdl_wa_savep_launch",
                                   "gdl_wa_qkv_savep_launch",
                                   "gdl_wa_qkv_savep_rows_launch",
                                   "gdl_wa_qkv_fwd_launch",
                                   "gdl_wa_bhnd_launch",
                                   "gdl_wa_packed_launch"])
def test_forward_entries_take_the_windows_a_block_walks(entry):
    """Every forward entry takes wpb right after nW, before the scale, as
    its ctypes argtypes and the op wrappers pass it."""
    for name in ("window_attention_eval", "window_attention_train",
                 "window_attention_bhnd"):
        source_file, entries = kernels.LIBRARIES[name]
        if entry in entries:
            break
    source = (kernels.KERNEL_DIR / source_file).read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params[-5:] == ["nw", "wpb", "scale", "dtype", "stream"], params
    assert entries[entry][0][-5:] == [kernels._int, kernels._int,
                                      kernels._float, kernels._int,
                                      kernels._vp]
