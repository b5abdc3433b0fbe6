"""SE(3) protein backbone models (port of ``superdiff_tpu/models/protein``):
rigid algebra, the R^3 / IGSO(3) / SE(3) diffusers, backbone geometry, the
IPA score network, the checkpoint-faithful FrameDiff and Proteus networks
and the reference checkpoint loader."""

from . import backbone, rigid
from .ipa import IPAConfig, IPAScoreNetwork
from .r3 import R3Diffuser
from .se3 import SE3Diffuser
from .so3 import SO3Diffuser

__all__ = [
    "rigid",
    "backbone",
    "R3Diffuser",
    "SO3Diffuser",
    "SE3Diffuser",
    "IPAConfig",
    "IPAScoreNetwork",
]
