"""gdl_tpu_torch — the PyTorch/CUDA port of gdl_tpu for NVIDIA Hopper.

`gdl_tpu` (JAX/Pallas) is the reference this package is held to: every
module here mirrors the module of the same name there, and the tests in
`tests/test_torch_*.py` load the same weights into both and compare.

The port imports `torch`, never `jax` or `flax`, and nothing of
`gdl_tpu`, not even a module there that imports no JAX: it keeps its own
copy of what it needs (`config.py`, the numpy host data code, the
utilities). Only the tests import both packages.

Every Pallas kernel on a ported path becomes a hand-written CUDA kernel
(`gdl_tpu_torch/kernels/`), built with nvcc at first use. Each kernel's
wrapper keeps a plain PyTorch version of the same math beside it; the
wrapper takes the plain version only for tensors on the CPU, and on a
CUDA tensor it launches the kernel or raises.

Ported so far: the dual Swin-B DGL classifier at eval, served from a
reference-schema `.pth` checkpoint (`gdl_tpu_torch.serve`), its DGL
training step (`gdl_tpu_torch.train`: the one-backward DGL loss, clip +
SGD + LR schedule, on-device augmentation), and the ResNet-18 DGL
trainer end to end: `python -m gdl_tpu_torch.main_dgl` (datasets,
loader, loop, eval, CSV logs, `.pth` checkpoints and resume).
"""

__version__ = "0.1.0"
