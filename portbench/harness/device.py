"""The device a run measures: the refusal without enough cards, the
precision settings a configuration states, and what the result line
says of the card."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gdl_tpu")


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int):
    """The first card, or NoDevice where CUDA is absent or has fewer
    cards than the cell asks for. Never a fall back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def set_precision() -> None:
    """The matrix products and convolutions in float32 with TF32 off, the
    precision every configuration states (`compute_dtype`)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def describe(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (gdl_tpu_torch is not gdl_tpu)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})
