"""Generator modules of the port."""

from cyclegan_tpu_torch.models.generator import ResNetGenerator

__all__ = ["ResNetGenerator"]
