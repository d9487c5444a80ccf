"""The port's serving artifacts (`gdl_tpu_torch/serve.py`, torch.export)
against gdl_tpu's (`gdl_tpu/serve.py`, jax.export), on the CPU.

One reference-schema `.pth` per case, written from gdl_tpu's parameters
through the weight bridge (`state_dict_from_flax`): gdl_tpu's
`export_from_checkpoint(..., platforms=("cpu",))` and the port's
`export_from_checkpoint(..., devices=("cpu",))` each write an artifact
from it, and both replay the same numpy inputs. Tolerance: atol 2e-4,
rtol 1e-4 on every output, that of the whole-model eval tests
(`tests/test_torch_serve.py`, `tests/test_torch_intermediate.py`). Also:
poly-batch artifacts at batches 3 and 5, a fixed artifact refusing
another batch, mmformer_n through `export_eval` with `apply_kwargs`, the
bf16 artifact against the eager bf16 server, a device the artifact was
not exported for, and the kernel operators' fake implementations
against their plain versions under FakeTensorMode.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu.serve import export_eval as jax_export_eval
from gdl_tpu.serve import export_from_checkpoint as jax_export_ckpt
from gdl_tpu.serve import load_exported as jax_load_exported
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.serve import (
    export_eval,
    export_from_checkpoint,
    load_exported,
    load_from_checkpoint,
)
from gdl_tpu_torch.utils.interop import state_dict_from_flax

ATOL, RTOL = 2e-4, 1e-4
BATCH = 3
TINY = dict(encoder_width=8, encoder_stages=[1, 1, 1, 1], batch_size=BATCH,
            fps=1, dataset="CREMAD", fusion_method="concat",
            modality="full", log_grad_csv=False)
TINY_SWIN = dict(TINY, backbone="swin", swin_embed_dim=16,
                 swin_depths=[2, 2], swin_heads=[2, 4], swin_window=7,
                 swin_img_size=56, swin_patch=4, use_pallas_attn=False)
CASES = {"resnet_dgl": (TINY, True), "swin_dgl": (TINY_SWIN, True),
         "resnet_joint": (TINY, False)}


def _first_vml_calls_on_one_thread():
    """torch.exp, torch.log, ... on CPU float tensors call MKL's vector
    math library, which picks its code path at a process's first call of
    each function. When two OpenMP threads make that first call at once,
    one of them can take a path 1.5e-4 relative from exp for its chunk
    (2 of 48 fresh processes with two threads; the PE head's std, output
    2 of mmformer_n's 7-tuple, crossed RTOL so). One call of each on one
    thread first; every later call is exact to an ulp."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    x = torch.ones(64)
    for fn in (torch.exp, torch.log, torch.sqrt, torch.tanh, torch.erf,
               torch.sin, torch.cos):
        fn(x)
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    _first_vml_calls_on_one_thread()
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def _jax_variables(case):
    """gdl_tpu's classifier of CASES[case], initialised from PRNGKey(7) at
    the exporter's input shapes, with non-trivial BN statistics."""
    from gdl_tpu.models.classifier import (
        AVClassifier,
        AVClassifierDGL,
        AVClassifierSwinDGL,
    )

    kw, dgl = CASES[case]
    cfg = JaxConfig(**kw)
    cls = (AVClassifierSwinDGL if cfg.backbone == "swin" else
           AVClassifierDGL if dgl else AVClassifier)
    model = cls(config=cfg)
    f, t = cfg.spec_shape
    variables = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((2, f, t, 1)),
        jnp.zeros((2, 1, 224, 224, 3)), train=False))(jax.random.PRNGKey(7))
    params = _np_tree(variables["params"])
    stats = _np_tree(variables.get("batch_stats", {}))
    _TEMPLATES[cls.__name__, cfg.backbone] = params, stats
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: x + (
            rng.uniform(0.0, 0.5, np.shape(x)) if "var" in
            jax.tree_util.keystr(p) else
            0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
        stats)
    return cfg, params, stats


@pytest.fixture
def jax_templates(monkeypatch):
    """gdl_tpu's exporter builds its model state with an eager flax init
    (`create_train_state`, 20 s a model here) that the checkpoint then
    overwrites. The test hands it a state of zeros shaped like the
    model's instead, so a restore that loaded nothing would fail."""
    import gdl_tpu.train.dgl as jax_dgl

    def zeros_state(model, cfg, rng, optimizer, **kw):
        params, stats = _TEMPLATES[type(model).__name__, cfg.backbone]
        params = jax.tree.map(np.zeros_like, params)
        return jax_dgl.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree.map(np.zeros_like, stats),
            opt_state=optimizer.init(params))

    monkeypatch.setattr(jax_dgl, "create_train_state", zeros_state)


_TEMPLATES = {}


def _write_pth(tmp_path, params, stats, cfg) -> str:
    path = os.path.join(tmp_path, "best_model.pth")
    torch.save({"model": {"module." + k: v for k, v in
                          state_dict_from_flax(params, stats).items()},
                "fusion": cfg.fusion_method}, path)
    return path


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    f, t = cfg.spec_shape
    return (rng.standard_normal((batch, f, t, 1)).astype(np.float32),
            rng.standard_normal((batch, 1, 224, 224, 3)).astype(np.float32))


def _close(got, want, n):
    assert len(got) == len(want) == n
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, torch.Tensor):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"output {i}")
        else:  # the joint tuple's PE entries without --pe
            assert g == 0 and np.all(np.asarray(w) == 0), i


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_gdl_tpu(case, tmp_path, jax_templates):
    """DGL (out, out_a, out_v) for both backbones and the joint 11-tuple:
    fixed-shape CPU artifacts of one .pth replay the same inputs alike;
    the port's refuses another batch, as gdl_tpu's does."""
    kw, dgl = CASES[case]
    jcfg, params, stats = _jax_variables(case)
    pth = _write_pth(tmp_path, params, stats, jcfg)
    cfg = Config(**kw, device="cpu")
    jax_export_ckpt(jcfg, pth, str(tmp_path / "j.hlo"), platforms=("cpu",),
                    dgl=dgl)
    export_from_checkpoint(cfg, pth, str(tmp_path / "p.pt2"),
                           devices=("cpu",), dgl=dgl)
    audio, visual = _inputs(cfg, BATCH, seed=11)
    want = jax_load_exported(str(tmp_path / "j.hlo")).call(audio, visual)
    served = load_exported(str(tmp_path / "p.pt2"), "cpu")
    _close(served.call(audio, visual), want, 3 if dgl else 11)
    a2, v2 = _inputs(cfg, BATCH + 1, seed=12)
    with pytest.raises(Exception):
        served.call(a2, v2)


def test_poly_batch_artifact_matches_gdl_tpu(tmp_path, jax_templates):
    """One symbolic batch dimension: both packages' artifacts serve
    batches 3 and 5 from one file."""
    jcfg, params, stats = _jax_variables("resnet_dgl")
    pth = _write_pth(tmp_path, params, stats, jcfg)
    cfg = Config(**TINY, device="cpu")
    jax_export_ckpt(jcfg, pth, str(tmp_path / "j.hlo"), platforms=("cpu",),
                    poly_batch=True)
    exported = export_from_checkpoint(cfg, pth, str(tmp_path / "p.pt2"),
                                      poly_batch=True, device="cpu")
    assert exported.devices == ("cpu", "cuda") and exported.poly_batch
    jax_art = jax_load_exported(str(tmp_path / "j.hlo"))
    served = load_exported(str(tmp_path / "p.pt2"), "cpu")
    for batch in (3, 5):
        audio, visual = _inputs(cfg, batch, seed=20 + batch)
        got = served.call(audio, visual)
        assert tuple(got[0].shape) == (batch, cfg.n_classes)
        _close(got, jax_art.call(audio, visual), 3)


def test_poly_batch_swin_keeps_the_batch_symbolic(tmp_path, jax_templates):
    """The Swin window partitions and the [B·nW] fold of shifted blocks
    do not pin the batch: one artifact serves batches 3 and 5 as
    gdl_tpu's poly-batch artifact of the same .pth does, and as the
    port's eager model does."""
    jcfg, params, stats = _jax_variables("swin_dgl")
    pth = _write_pth(tmp_path, params, stats, jcfg)
    cfg = Config(**TINY_SWIN, device="cpu")
    jax_export_ckpt(jcfg, pth, str(tmp_path / "j.hlo"), platforms=("cpu",),
                    poly_batch=True)
    export_from_checkpoint(cfg, pth, str(tmp_path / "p.pt2"),
                           poly_batch=True, device="cpu")
    jax_art = jax_load_exported(str(tmp_path / "j.hlo"))
    served = load_exported(str(tmp_path / "p.pt2"), "cpu")
    eager = load_from_checkpoint(cfg, pth, "cpu")
    for batch in (3, 5):
        audio, visual = _inputs(cfg, batch, seed=30 + batch)
        got = served.call(audio, visual)
        assert tuple(got[0].shape) == (batch, cfg.n_classes)
        _close(got, jax_art.call(audio, visual), 3)
        _close(got, eager(audio, visual), 3)


def test_mmformer_n_export_eval_with_apply_kwargs(tmp_path):
    """mmformer_n's 7-tuple through both packages' `export_eval` with
    apply_kwargs={"av_inputs": True}: the AV adapter runs inside the
    artifact."""
    from gdl_tpu.models import intermediate as jax_inter
    from gdl_tpu_torch.models import intermediate as port_inter

    kw = dict(num_classes=6, embed_dim=128, width=8, seq_len=196,
              share_streams=True)
    jmodel = jax_inter.MMFormerN(**kw)
    cfg = Config(**TINY, device="cpu")
    f, t = cfg.spec_shape
    k = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k, "drop": k, "dropout": k, "pe": k},
        jnp.zeros((2, f, t, 1)), jnp.zeros((2, 1, 224, 224, 3)),
        train=False, av_inputs=True))(k)
    variables = _np_tree(variables)
    audio, visual = _inputs(cfg, 2, seed=31)
    want = jax_export_eval(jmodel, variables, (audio, visual),
                           platforms=("cpu",),
                           apply_kwargs={"av_inputs": True}).call(audio,
                                                                  visual)
    model = port_inter.MMFormerN(**kw)
    model.load_state_dict(state_dict_from_flax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    exported = export_eval(model, (torch.from_numpy(audio),
                                   torch.from_numpy(visual)),
                           devices=("cpu",),
                           apply_kwargs={"av_inputs": True})
    exported_path = str(tmp_path / "mm.pt2")
    from gdl_tpu_torch.serve import save_exported

    save_exported(exported, exported_path)
    _close(load_exported(exported_path, "cpu").call(audio, visual), want, 7)


def test_bf16_artifact_is_the_eager_bf16_server(tmp_path):
    """A bfloat16 config exports its forward under bf16 autocast: the
    artifact's logits are the eager bf16 ServedModel's."""
    cfg = Config(**dict(TINY, compute_dtype="bfloat16"), device="cpu")
    pth = os.path.join(tmp_path, "best_model.pth")
    from gdl_tpu_torch.serve import build_model

    torch.save({"model": build_model(cfg, seed=5).state_dict()}, pth)
    export_from_checkpoint(cfg, pth, str(tmp_path / "p.pt2"),
                           devices=("cpu",))
    audio, visual = _inputs(cfg, BATCH, seed=41)
    got = load_exported(str(tmp_path / "p.pt2"), "cpu").call(audio, visual)
    want = load_from_checkpoint(cfg, pth, "cpu")(audio, visual)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_a_device_not_exported_for_raises_by_name(tmp_path):
    cfg = Config(**TINY, device="cpu")
    from gdl_tpu_torch.serve import build_model, save_exported

    audio, visual = (torch.from_numpy(x) for x in _inputs(cfg, 2, seed=1))
    exported = export_eval(build_model(cfg, seed=1), (audio, visual))
    assert exported.devices == ("cpu",)
    save_exported(exported, str(tmp_path / "p.pt2"))
    with pytest.raises(ValueError, match=r"exported for devices \('cpu',\)"
                                         r", not 'cuda'"):
        load_exported(str(tmp_path / "p.pt2"), "cuda")
    with pytest.raises(ValueError, match="devices"):
        export_eval(build_model(cfg, seed=1), (audio, visual),
                    devices=("cuda",))


def _op_cases(dt):
    from gdl_tpu_torch.ops.mlp import mlp_fused_ref
    from gdl_tpu_torch.ops.self_attention import (
        self_attention_fused_eval_ref,
    )
    from gdl_tpu_torch.ops.window_attention import (
        window_attention_qkv_fused_eval_ref,
    )

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dt)

    heads, c = 2, 32
    bias = torch.randn(heads, 49, 49, generator=g)
    mask = torch.randn(2, 49, 49, generator=g)
    return [
        ("wa_qkv_fused_eval", (r(4, 49, c), r(3 * c, c), r(3 * c), bias,
                               mask, heads, 0.25),
         window_attention_qkv_fused_eval_ref),
        ("sa_fused_eval", (r(2, 10, c), r(3 * c, c), heads, 0.25),
         self_attention_fused_eval_ref),
        ("mlp_fused_fwd", (r(20, c), r(4 * c, c), r(4 * c), r(c, 4 * c),
                           r(c)), mlp_fused_ref),
    ]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fake_implementations_give_the_plain_shapes(dt):
    """Each kernel operator's fake implementation, the one torch.export
    traces, gives its plain version's shape and dtype; the operators
    themselves have no CPU implementation."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for name, args, plain in _op_cases(dt):
        op = getattr(torch.ops.gdl_tpu_torch, name)
        want = plain(*args)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args]
            got = op(*fake)
        assert tuple(got.shape) == tuple(want.shape), name
        assert got.dtype == want.dtype == dt, name
        with pytest.raises(NotImplementedError):
            op(*args)
