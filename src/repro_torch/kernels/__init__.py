"""Hand-written Hopper kernels, each with a plain PyTorch version beside it:

* conv2d    -- direct NHWC x HWIO conv (counterpart of the Pallas kernel
               ``repro/kernels/conv2d``), CUDA C++ for sm_90a
* halo_conv -- HALP-fused conv of a height shard and its halos (counterpart
               of ``repro/kernels/halo_conv``), CUDA C++ for sm_90a
* attention -- flash attention on [B, H, T, D], with a GQA wrapper in the
               model layout (counterpart of ``repro/kernels/attention``),
               CUDA C++ for sm_90a

The two convs share the implicit-GEMM core ``conv_igemm.cuh``.
"""
