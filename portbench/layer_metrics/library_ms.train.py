"""library_ms.train: device ms a training step of the libraries' kernels
under the models: cuDNN convolutions and cuBLAS / CUTLASS GEMMs (the
kinds "convolution" and "gemm" of `harness/kinds.py`), from the trace."""

from __future__ import annotations


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(["convolution", "gemm"])
    return ms if ms > 0 else None
