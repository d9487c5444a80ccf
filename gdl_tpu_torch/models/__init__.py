"""Models of the port: the Swin encoder, the fusion heads and the
classifier assemblies, named in the reference checkpoint layout."""

from gdl_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    resnet18,
    resnet50,
)
