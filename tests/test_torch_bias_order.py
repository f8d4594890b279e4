"""The order of a conv's bias in bfloat16, held against the JAX reference.

JAX ``models/layers.py: conv2d`` (l.35-36) and the Pallas wrappers
(``kernels/conv2d/ops.py: conv2d_pallas`` l.82-83, ``kernels/halo_conv/
halo_conv.py: halo_conv2d`` l.117-118) round the float32 conv sum to bfloat16
and then add the bias in bfloat16.  The port's kernels and their plain
versions do the same (``conv_igemm.cuh: finish``), so both sides round the
sum at the same place and land at most a step or two of bfloat16 apart
(different summation orders can tip one rounding).  Held elementwise at the
bfloat16 ``_tol`` of ``tests/test_kernels.py``, 2e-2 * (1 + |y|), on the CPU,
where the port's wrappers run their plain versions; the kernels hold the same
order on the card in ``chip_smoke.py`` phases 3 / 3b against those plain
versions.  Biases are large (|b| up to ~3) against conv sums of ~1, so a
bias added before the rounding moves many elements by a bf16 step or more:
the tolerance alone would not see that (the old order met it, with 71 % of
the elements bit-equal to JAX's), so the share of bit-equal elements is held
too, at 99 % (a different summation order may tip a rare rounding).
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels.halo_conv import halo_conv2d
from repro.models import layers as jlayers
from repro_torch.kernels.halo_conv import halo_conv2d_cuda
from repro_torch.models import layers

TOL = 2e-2


def _bf16(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).bfloat16()


def _assert_within_tol(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL * (1 + np.abs(want)))
    assert np.mean(got == want) >= 0.99


def test_conv2d_layer_bfloat16_matches_jax():
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, (2, 9, 8, 16))
    jw, tw = _bf16(rng, (3, 3, 16, 24), scale=0.1)
    jb, tb = _bf16(rng, (24,), scale=1.5)
    want = jlayers.conv2d(jx, {"w": jw, "b": jb}, padding="SAME")
    _assert_within_tol(layers.conv2d(tx, {"w": tw, "b": tb}, padding="SAME"), want)


def test_halo_conv_bfloat16_matches_jax():
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng, (2, 8, 10, 12))
    jtop, ttop = _bf16(rng, (2, 1, 10, 12))
    jbot, tbot = _bf16(rng, (2, 1, 10, 12))
    jw, tw = _bf16(rng, (3, 3, 12, 20), scale=0.1)
    jb, tb = _bf16(rng, (20,), scale=1.5)
    want = halo_conv2d(jx, jtop, jbot, jw, jb, stride=1, padding=1, interpret=True)
    _assert_within_tol(halo_conv2d_cuda(tx, ttop, tbot, tw, tb, stride=1, padding=1), want)
