from .ops import conv2d_cuda
from .ref import conv2d_ref

__all__ = ["conv2d_cuda", "conv2d_ref"]
