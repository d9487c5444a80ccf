"""`--pretrained_path` (`gdl_tpu_torch/utils/interop.py::
load_pretrained_encoders`) against gdl_tpu's
(`gdl_tpu/utils/torch_interop.py:287`), and `resnet50` against gdl_tpu's,
on the CPU.

One torchvision-style backbone state dict is built in the test (nothing
is downloaded): the names of torchvision's resnet18 at width 8 with one
block a stage, a second block's keys that no encoder has, and `fc.*`,
saved as {"model": ...} with `module.` prefixes. gdl_tpu loads it into
its state and the port into its modules, from the same initial weights:
the port's tensors equal gdl_tpu's after the bridge (exactly: both copy
the same floats), the two print the same report lines and report the
same keys. Tolerance of `resnet50` at eval: 2e-5, that of the ResNet-18
encoders (`tests/test_torch_resnet.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdl_tpu.config import Config as JaxConfig
from gdl_tpu_torch.config import Config
from gdl_tpu_torch.models.classifier import AVClassifierDGL
from gdl_tpu_torch.models.resnet import resnet18, resnet50
from gdl_tpu_torch.utils.interop import (
    load_pretrained_encoders,
    state_dict_from_flax,
)

TINY = dict(dataset="CREMAD", fusion_method="concat", modality="full",
            modulation="Normal", fps=1, batch_size=2, encoder_width=8,
            encoder_stages=[1, 1, 1, 1])


@pytest.fixture(autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _save_backbone(path) -> dict:
    """A torchvision-format resnet18 state dict at the tiny width, values
    from a numpy seed; written as a reference checkpoint would be."""
    rng = np.random.default_rng(4)
    names = resnet18("visual", width=8, stage_sizes=[1, 1, 1, 1]).state_dict()
    sd = {}
    for k, v in names.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(5)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(
                np.float32))
        else:
            sd[k] = torch.from_numpy(rng.standard_normal(v.shape).astype(
                np.float32))
    # torchvision's second block of a stage, and its classifier
    sd["layer1.1.conv1.weight"] = torch.ones(8, 8, 3, 3)
    sd["fc.weight"] = torch.ones(1000, 64)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    return sd


def test_pretrained_load_matches_gdl_tpu(tmp_path, capsys):
    """Both encoders adopt the file's tensors, running statistics
    included; the 1-channel audio stem is skipped for shape, `fc.*` and
    the extra block are ignored, the fusion head keeps its weights."""
    from gdl_tpu.models.classifier import AVClassifierDGL as JaxDGL
    from gdl_tpu.train.dgl import TrainState
    from gdl_tpu.utils.torch_interop import (
        load_pretrained_encoders as jax_load_pretrained,
    )

    path = str(tmp_path / "resnet18_imagenet.pth")
    sd = _save_backbone(path)
    jcfg = JaxConfig(**TINY)
    jmodel = JaxDGL(config=jcfg)
    f, t = jcfg.spec_shape
    variables = _np_tree(jax.jit(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((2, f, t, 1)),
        jnp.zeros((2, 1, 224, 224, 3)), train=False))(jax.random.PRNGKey(0)))
    state = TrainState(step=0, params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=())
    model = AVClassifierDGL(Config(**TINY, device="cpu"))
    model.load_state_dict(state_dict_from_flax(variables["params"],
                                               variables["batch_stats"]),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    capsys.readouterr()
    new_state, jax_reports = jax_load_pretrained(state, path)
    jax_lines = capsys.readouterr().out.splitlines()
    reports = load_pretrained_encoders(model, path)
    lines = capsys.readouterr().out.splitlines()

    assert lines == jax_lines and len(lines) == 2
    assert sorted(reports) == sorted(jax_reports) == ["audio_net",
                                                      "visual_net"]
    for target, rep in reports.items():
        for key in ("missing", "mismatched", "unexpected"):
            assert sorted(rep[key]) == sorted(jax_reports[target][key]), (
                target, key)
    assert reports["audio_net"]["mismatched"] == ["conv1.weight"]
    assert reports["visual_net"]["mismatched"] == []
    assert {"fc.weight", "fc.bias", "layer1.1.conv1.weight"} <= set(
        reports["visual_net"]["unexpected"])

    want = state_dict_from_flax(_np_tree(new_state.params),
                                _np_tree(new_state.batch_stats))
    got = model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
        assert torch.equal(got[k], before[k]) == (
            k.startswith("fusion_module.") or k == "audio_net.conv1.weight"
            or k.endswith("num_batches_tracked")), k
    for k in ("visual_net.conv1.weight", "audio_net.bn1.running_var",
              "visual_net.layer4.0.downsample.1.running_mean"):
        assert torch.equal(got[k], sd[k.split(".", 1)[1]]), k


def test_the_harness_loads_the_pretrained_path(tmp_path, capsys):
    """`--pretrained_path` is no longer refused: building the harness
    partial-loads it into the encoders."""
    from gdl_tpu_torch.train.loop import build_harness

    path = str(tmp_path / "resnet18_imagenet.pth")
    sd = _save_backbone(path)
    cfg = Config(**TINY, device="cpu", pretrained_path=path,
                 log_grad_csv=False)
    h = build_harness(cfg, AVClassifierDGL(cfg), steps_per_epoch=2)
    assert "pretrained[visual_net]: loaded=" in capsys.readouterr().out
    got = h.model.state_dict()
    assert torch.equal(got["visual_net.layer2.0.conv2.weight"],
                       sd["layer2.0.conv2.weight"])
    assert not torch.equal(got["audio_net.conv1.weight"][:, :1],
                           sd["conv1.weight"][:, :1])


def test_resnet50_matches_gdl_tpu_at_eval():
    """resnet50 is gdl_tpu's BasicBlock [3, 4, 6, 3] (mislabeled in the
    reference), not a bottleneck net: the same keys and maps."""
    from gdl_tpu.models.resnet import resnet50 as jax_resnet50

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 48, 48, 3)).astype(np.float32)
    jnet = jax_resnet50("visual", width=8)
    variables = _np_tree(jax.jit(lambda k: jnet.init(
        {"params": k}, jnp.asarray(x), train=False))(jax.random.PRNGKey(2)))
    stats = jax.tree.map(
        lambda s: s + rng.uniform(0.0, 0.5, s.shape).astype(s.dtype),
        variables["batch_stats"])
    want = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x))
    net = resnet50("visual", width=8)
    net.load_state_dict(state_dict_from_flax(variables["params"], stats),
                        strict=True)
    assert [len(getattr(net, f"layer{s}")) for s in (1, 2, 3, 4)] == [
        3, 4, 6, 3]
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
