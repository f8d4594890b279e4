from .ops import halo_conv2d_cuda
from .ref import halo_conv2d_ref

__all__ = ["halo_conv2d_cuda", "halo_conv2d_ref"]
