// K3 (attention.cu) at the diffusion models' head widths, as a library of
// its own: UNet-SD1.5's 8 heads over 320 / 640 / 1280 channels (D = 40, 80,
// 160) and DiT-XL/2's 16 heads over 1152 (D = 72).  The 48 instantiations
// (2 types x 2 copy kinds x 3 block shapes x 4 pairs) would about double
// attention.cu's compile; apart, the two build in parallel
// (kernels/_build.py).  40 and 72 are not multiples of 16: attention.cu's
// Warp structs handle the last half slice of QK^T.
#define K3_PAIRS(X) X(40, 40) X(72, 72) X(80, 80) X(160, 160)
#include "attention.cu"
