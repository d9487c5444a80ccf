"""gdl_tpu_torch — the PyTorch/CUDA port of gdl_tpu for NVIDIA Hopper.

`gdl_tpu` (JAX/Pallas) is the reference this package is held to: every
module here mirrors the module of the same name there, and the tests in
`tests/test_torch_*.py` load the same weights into both and compare.

The port imports `torch` and never `jax` or `flax`. From `gdl_tpu` it
imports only the pure-Python `gdl_tpu.config`, so one `Config` and one
CLI surface serve both packages; host pieces of `gdl_tpu` that pull in
jax (data preprocessing, checkpoint helpers) are ported, not imported.

Every Pallas kernel on a ported path becomes a hand-written CUDA kernel
(`gdl_tpu_torch/kernels/`), built with nvcc at first use. Each kernel's
wrapper keeps a plain PyTorch version of the same math beside it; the
wrapper takes the plain version only for tensors on the CPU, and on a
CUDA tensor it launches the kernel or raises.

Ported so far: the dual Swin-B DGL classifier at eval, served from a
reference-schema `.pth` checkpoint (`gdl_tpu_torch.serve`), and its DGL
training step (`gdl_tpu_torch.train`: the one-backward DGL loss, clip +
SGD + LR schedule, on-device augmentation).
"""

__version__ = "0.1.0"
