"""Generator and discriminator modules of the port."""

from cyclegan_tpu_torch.models.discriminator import PatchGANDiscriminator
from cyclegan_tpu_torch.models.generator import ResNetGenerator

__all__ = ["PatchGANDiscriminator", "ResNetGenerator"]
