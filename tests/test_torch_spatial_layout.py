"""The spatial engine's integer layout helpers and argument checks against
the JAX package's (``repro/spatial/halo.py``): the same values for the same
inputs, and a raise wherever ``tests/test_spatial.py`` (l.129-241) pins one.
All of it runs in one process: these checks come before any exchange."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan_even as jplan_even
from repro.models import vgg as jvgg
from repro.spatial import halo as jhalo
from repro_torch.core import plan_even
from repro_torch.models import vgg
from repro_torch.spatial import LocalComm, conv2d_spatial, exchange_halos, max_pool_spatial
from repro_torch.spatial import halo

NET3 = dict(img_res=64, width_mult=0.125, num_classes=10, blocks=((2, 64), (2, 128), (3, 256)))
NETS = {
    "full": (vgg.FULL.geom(), jvgg.VGGConfig().geom()),
    "smoke": (vgg.SMOKE.geom(), jvgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()),
    "3-block": (vgg.VGGConfig(**NET3).geom(), jvgg.VGGConfig(**NET3).geom()),
}


def _same(fn, jfn, *args, **kwargs):
    """Both return the same value, or both raise ValueError with one message."""
    try:
        want = jfn(*args, **kwargs)
    except ValueError as e:
        with pytest.raises(ValueError) as exc:
            fn(*args, **kwargs)
        assert str(exc.value) == str(e)
        return None
    assert fn(*args, **kwargs) == want
    return want


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (1, 1, 0), (2, 2, 0), (7, 2, 3), (5, 1, 2), (7, 1, 3),
                                   (3, 2, 1), (5, 2, 3), (3, 1, 3), (3, 1, -1), (3, 3, 0)])
def test_halo_sizes_match(k, s, p):
    _same(halo.halo_sizes, jhalo.halo_sizes, k, s, p)


@pytest.mark.parametrize("total,n,ratios,align", [
    (64, 4, None, 1), (64, 4, (1.0, 0.55, 0.35, 0.8), 8), (60, 3, (3, 2, 1), 2),
    (224, 4, (1.0, 0.55, 0.35, 0.8), 32), (224, 7, None, 32), (64, 8, (4, 3, 2, 1, 1, 2, 3, 4), 2),
    (64, 4, (6, 3, 1, 6), 2), (64, 4, (4, 2, 1, 3), 4), (64, 3, (0, 1, 1), 8),
    (62, 4, None, 4), (16, 5, None, 8), (64, 4, (1, 2), 1), (64, 2, (-1, 2), 1), (64, 2, (0, 0), 1),
])
def test_shard_heights_match(total, n, ratios, align):
    _same(halo.shard_heights, jhalo.shard_heights, total, n, ratios=ratios, align=align)


@pytest.mark.parametrize("net", sorted(NETS))
def test_spatial_alignment_and_plan_shard_heights_match(net):
    g, jg = NETS[net]
    align = halo.spatial_alignment(g)
    assert align == jhalo.spatial_alignment(jg)
    for n, ratios in ((2, None), (4, None), (4, (1.0, 0.55, 0.35, 0.8)), (4, (4.0, 2.0, 1.0, 1.0)),
                      (7, None), (3, (3, 2, 1))):
        _same(lambda: halo.plan_shard_heights(plan_even(g, n, ratios=ratios), align=align),
              lambda: jhalo.plan_shard_heights(jplan_even(jg, n, ratios=ratios), align=align))
    if net == "full":  # the deployment chip_smoke.py phase 5 runs
        assert halo.plan_shard_heights(plan_even(g, 4, ratios=(1.0, 0.55, 0.35, 0.8)),
                                       align=align) == (96, 32, 32, 64)


@pytest.mark.parametrize("heights", [(12, 8, 4, 8), (8, 8, 8, 8), (24, 12, 4, 24), (1, 31)])
def test_padded_shard_layout_matches(heights):
    rng = np.random.default_rng(sum(heights))
    x = rng.standard_normal((2, sum(heights), 5, 3), dtype=np.float32)
    blocks = halo.to_padded_shards(torch.from_numpy(x), heights)
    jp = jhalo.to_padded_shards(jnp.asarray(x), heights)
    np.testing.assert_array_equal(torch.cat(blocks, dim=1).numpy(), np.asarray(jp))
    np.testing.assert_array_equal(halo.merge_padded_shards(blocks, heights).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jhalo.merge_padded_shards(jp, heights)), x)


def test_padded_shard_layout_rejects_like_jax():
    x = torch.zeros((2, 32, 5, 3))
    with pytest.raises(ValueError, match="sum of shard heights"):
        halo.to_padded_shards(x, (12, 8, 4, 4))
    blocks = halo.to_padded_shards(x, (12, 8, 4, 8))
    with pytest.raises(ValueError, match="blocks of"):
        halo.merge_padded_shards([b[:, :-1] for b in blocks], (12, 8, 4, 8))
    with pytest.raises(ValueError, match="blocks of"):
        halo.merge_padded_shards(blocks[:3], (12, 8, 4, 8))


def test_thin_shards_raise():
    """tests/test_spatial.py:140: a halo taller than the shard would need rows
    from two shards away; the exchange raises instead of truncating, and so
    does the overlapped schedule's own donation.  A halo of exactly the shard
    height is legal."""
    x = [torch.zeros((1, 2, 8, 3))] * 2  # 2-row shards
    with pytest.raises(ValueError, match="halo exceeds shard height"):
        exchange_halos(x, 3, 0)
    with pytest.raises(ValueError, match="halo exceeds shard height"):
        exchange_halos(x, 0, 3)
    halo._check_halo_fits(2, 2, 2)
    jhalo._check_halo_fits(2, 2, 2)
    params = {"w": torch.zeros((7, 7, 3, 4)), "b": torch.zeros(4)}
    for engine in ("direct", "fused"):
        with pytest.raises(ValueError, match="halo exceeds shard height"):
            conv2d_spatial(x, params, k=7, s=1, p=3, overlap=True, engine=engine)
    with pytest.raises(ValueError, match="halo exceeds shard height"):
        jhalo.conv2d_spatial(jnp.zeros((1, 2, 8, 3)), {"w": jnp.zeros((7, 7, 3, 4))}, k=7, s=1, p=3)


@pytest.mark.parametrize("heights,k,s,p,match", [
    ((8, 7, 8, 8), 3, 2, 1, "not all divisible by stride"),
    ((8, 2, 8, 8), 7, 1, 3, "halo exceeds shard height"),
    ((8, 0, 8, 8), 3, 1, 1, "positive"),
], ids=["stride", "halo", "positive"])
def test_weighted_conv_rejects_bad_heights(heights, k, s, p, match):
    """tests/test_spatial.py:229, on both engines."""
    params = {"w": torch.zeros((k, k, 3, 4)), "b": torch.zeros(4)}
    x = [torch.zeros((1, 8, 8, 3))] * 4
    for engine in ("direct", "fused"):
        with pytest.raises(ValueError, match=match):
            conv2d_spatial(x, params, k=k, s=s, p=p, heights=heights, engine=engine)
    with pytest.raises(ValueError, match=match):
        jhalo.conv2d_spatial(jnp.zeros((1, 8, 8, 3)), {"w": jnp.zeros((k, k, 3, 4))},
                             k=k, s=s, p=p, heights=heights)


def test_engine_and_layout_checks():
    x = [torch.zeros((1, 8, 8, 3))] * 4
    params = {"w": torch.zeros((3, 3, 3, 4)), "b": torch.zeros(4)}
    with pytest.raises(ValueError, match="unknown engine 'pallas'"):
        conv2d_spatial(x, params, 3, 1, 1, engine="pallas")
    with pytest.raises(ValueError, match="shard heights for 4 shards"):
        conv2d_spatial(x, params, 3, 1, 1, heights=(4, 4, 8))
    with pytest.raises(ValueError, match="block height 8 != max shard height 6"):
        conv2d_spatial(x, params, 3, 1, 1, heights=(6, 6, 6, 6))
    with pytest.raises(ValueError, match="for a comm holding 2 locally"):
        conv2d_spatial(x, params, 3, 1, 1, comm=LocalComm(2, "cpu"))
    with pytest.raises(ValueError, match="not divisible by stride"):
        conv2d_spatial([torch.zeros((1, 7, 8, 3))] * 2, params, 3, 2, 1)
    with pytest.raises(ValueError, match="not aligned to pool stride"):
        max_pool_spatial([torch.zeros((1, 7, 8, 3))] * 2, 2, 2)
    with pytest.raises(ValueError, match="differ in shape"):
        conv2d_spatial([torch.zeros((1, 8, 8, 3)), torch.zeros((1, 6, 8, 3))], params, 3, 1, 1)


@pytest.mark.parametrize("k,s,p,groups,w,want", [
    (3, 1, 1, 1, 8, True), (3, 1, 3, 1, 8, False), (5, 1, 1, 1, 2, False), (3, 1, 1, 1, 1, True),
    (3, 1, 1, 4, 8, True), (3, 1, 1, 2, 8, False),
])
def test_fused_supported_matches_pallas_supported(k, s, p, groups, w, want):
    """``_fused_supported`` is ``_pallas_supported``'s counterpart: the same
    verdict for the same geometry, groups and width."""
    c = 4
    wts = np.zeros((k, k, 1 if groups == c else c // groups, c), np.float32)
    got = halo._fused_supported(k, s, p, groups, c, torch.from_numpy(wts), w)
    assert got == jhalo._pallas_supported(k, s, p, groups, c, jnp.asarray(wts), w) == want
