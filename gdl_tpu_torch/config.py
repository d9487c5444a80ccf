"""Configuration shared with the reference package.

`gdl_tpu.config` is pure Python (it imports neither jax nor flax), so the
port re-exports it instead of copying it: one `Config` dataclass and one
CLI surface serve both packages. `Config.bn_groups` imports jax lazily;
the Swin path has no BatchNorm and never calls it.
"""

from gdl_tpu.config import (  # noqa: F401
    AUDIO_PARAMS,
    N_CLASSES,
    Config,
    add_arguments,
    spectrogram_shape,
)

__all__ = ["AUDIO_PARAMS", "N_CLASSES", "Config", "add_arguments",
           "spectrogram_shape"]
