"""The port's serving path against gdl_tpu's: the weight bridge, a
reference-schema `.pth` served end to end from raw requests, the import
boundary (no jax, no flax, nothing of gdl_tpu), the port's own Config
held to gdl_tpu's, and no silent CPU fallback for a CUDA request."""

import argparse
import dataclasses

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gdl_tpu.config as jax_config
import gdl_tpu_torch.config as port_config
from gdl_tpu.config import Config
from gdl_tpu.data.preprocess import make_eval_preprocess as jax_preprocess
from gdl_tpu.models.classifier import AVClassifierSwinDGL as JaxSwinDGL
from gdl_tpu.train.dgl import create_train_state
from gdl_tpu.train.dgl import make_eval_step as jax_make_eval_step
from gdl_tpu.train.optim import make_optimizer
from gdl_tpu.utils.torch_interop import flax_to_torch_state_dict
from gdl_tpu_torch.data.synthetic import synthetic_batch
from gdl_tpu_torch.models.classifier import AVClassifierSwinDGL
from gdl_tpu_torch.serve import load_from_checkpoint
from gdl_tpu_torch.utils.interop import state_dict_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SWIN = dict(encoder_width=8, encoder_stages=[1, 1, 1, 1], batch_size=2,
                 fps=1, dataset="CREMAD", fusion_method="concat",
                 modality="full", log_grad_csv=False, backbone="swin",
                 swin_embed_dim=16, swin_depths=[1, 1], swin_heads=[2, 4],
                 swin_window=7, swin_img_size=56, swin_patch=4)


@pytest.fixture(scope="module")
def jax_state():
    """Tiny dual-Swin DGL state, initialised as gdl_tpu's exporter does
    (dataset-shaped 224² dummies) but from PRNGKey(7)."""
    cfg = Config(**TINY_SWIN)
    model = JaxSwinDGL(config=cfg)
    state = create_train_state(model, cfg, jax.random.PRNGKey(7),
                               make_optimizer(cfg, 1))
    return cfg, model, state


def test_bridge_equals_reference_interop_and_loads_strictly(jax_state):
    cfg, _, state = jax_state
    ours = state_dict_from_flax(state.params, state.batch_stats)
    ref = flax_to_torch_state_dict(state.params, state.batch_stats,
                                   prefix="")
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    AVClassifierSwinDGL(cfg).load_state_dict(ours, strict=True)


def test_reference_pth_serves_raw_requests_like_gdl_tpu(jax_state, tmp_path):
    """A `module.`-prefixed {"model": sd} file written by torch.save is
    served by the port; raw synthetic requests give the preds of
    gdl_tpu's make_eval_step(make_eval_preprocess(cfg)) and its logits
    (atol 2e-4)."""
    cfg, model, state = jax_state
    sd = flax_to_torch_state_dict(state.params, state.batch_stats)
    path = os.path.join(tmp_path, "best_model.pth")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()},
                "fusion": cfg.fusion_method, "acc": 0.5}, path)
    served = load_from_checkpoint(cfg, path, device="cpu")

    batch = synthetic_batch(cfg, 2, seed=21)
    got = served.eval_batch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_make_eval_step(model, cfg, jax_preprocess(cfg))(state, jbatch)
    for k in ("pred", "pred_a", "pred_v", "label"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)

    pre = jax_preprocess(cfg)(jbatch)
    logits = model.apply({"params": state.params}, pre["audio"],
                         pre["visual"], train=False)
    for g, w in zip(got["logits"], logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)
    # the preprocessed-input callable gives the same logits
    out = served(np.array(pre["audio"]), np.array(pre["visual"]))
    for g, w in zip(out, logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)


def test_partial_bare_state_dict_loads_with_strict_false(tmp_path):
    """valid.py semantics: a bare state dict (no {"model": ...} wrapper)
    missing some keys loads, the missing keys keep the model's current
    values, and the load warns with the count."""
    cfg = Config(**TINY_SWIN)
    src = AVClassifierSwinDGL(cfg, generator=torch.Generator().manual_seed(1))
    sd = {"module." + k: v for k, v in src.state_dict().items()
          if not k.startswith("fusion_module.")}
    path = os.path.join(tmp_path, "bare.pth")
    torch.save(sd, path)
    with pytest.warns(UserWarning, match="4 keys missing"):
        served = load_from_checkpoint(cfg, path, device="cpu")
    got = served.model.state_dict()
    fresh = AVClassifierSwinDGL(cfg, generator=torch.Generator().manual_seed(0))
    for k, v in src.state_dict().items():
        want = fresh.state_dict()[k] if k.startswith("fusion_module.") else v
        assert torch.equal(got[k], want), k


def test_port_imports_no_jax():
    """Every gdl_tpu_torch module and chip_smoke import; afterwards no
    module of gdl_tpu, jax, jaxlib, flax or optax is loaded."""
    code = (
        "import pkgutil, importlib, sys, gdl_tpu_torch\n"
        "for m in pkgutil.walk_packages(gdl_tpu_torch.__path__, "
        "'gdl_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('gdl_tpu', 'jax', 'jaxlib', 'flax', 'optax')]\n"
        "assert not bad, bad\n"
        "n = sum(1 for m in sys.modules if m.startswith('gdl_tpu_torch.'))\n"
        "assert n >= 30, n\n"
        "print('ok', n)\n")
    env = {k: v for k, v in os.environ.items() if k != "GDL_PLATFORM"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_config_equals_reference_config():
    """The port's own Config against gdl_tpu's: equal field names and
    defaults apart from `device`, equal AUDIO_PARAMS / N_CLASSES /
    spectrogram shapes, bn_groups without jax, and equal parsed values
    for the flagship (alpha 5) command line of scripts/cramed_dgl.sh."""
    assert port_config.Config is not jax_config.Config
    ref = {f.name: getattr(jax_config.Config(), f.name)
           for f in dataclasses.fields(jax_config.Config)}
    got = {f.name: getattr(port_config.Config(), f.name)
           for f in dataclasses.fields(port_config.Config)}
    assert got.pop("device") == "cuda"
    assert got == ref
    assert port_config.AUDIO_PARAMS == jax_config.AUDIO_PARAMS
    assert port_config.N_CLASSES == jax_config.N_CLASSES
    for ds in jax_config.AUDIO_PARAMS:
        for swin in (False, True):
            assert (port_config.spectrogram_shape(ds, swin)
                    == jax_config.spectrogram_shape(ds, swin))
    assert port_config.Config(sync_bn=False).bn_groups == 1
    assert port_config.Config(sync_bn=False, dp=4).bn_groups == 4

    script = open(os.path.join(REPO, "scripts", "cramed_dgl.sh")).read()
    line = [ln for ln in script.splitlines() if "main_dgl.py" in ln][-1]
    argv = line.split("main_dgl.py", 1)[1].split()
    parsed = []
    for mod in (jax_config, port_config):
        for dgl in (True, False):
            parser = argparse.ArgumentParser()
            mod.add_arguments(parser, dgl=dgl)
            extra = [] if dgl else ["--warmup", "1"]
            parsed.append(dataclasses.asdict(
                mod.from_args(parser.parse_args(argv + extra))))
    for mine, theirs in zip(parsed[2:], parsed[:2]):
        assert mine.pop("device") == "cuda"
        assert mine == theirs
    assert parsed[0]["alpha"] == 5.0 and parsed[0]["modulation"] == "Normal"


def test_cuda_request_without_cuda_raises(tmp_path, monkeypatch):
    """device='cuda' on a machine without CUDA raises; it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**TINY_SWIN)
    path = os.path.join(tmp_path, "m.pth")
    torch.save({"model": AVClassifierSwinDGL(cfg).state_dict()}, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_from_checkpoint(cfg, path, device="cuda")
