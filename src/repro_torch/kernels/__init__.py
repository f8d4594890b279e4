"""Hand-written Hopper kernels, each with a plain PyTorch version beside it:

* conv2d -- direct NHWC x HWIO conv (counterpart of the Pallas kernel
            ``repro/kernels/conv2d``), CUDA C++ for sm_90a
"""
