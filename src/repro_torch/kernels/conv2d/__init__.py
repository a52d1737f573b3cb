from .ops import conv2d
from .ref import avgpool2d_ref, conv2d_ref, maxpool2d_ref

__all__ = ["conv2d", "conv2d_ref", "maxpool2d_ref", "avgpool2d_ref"]
