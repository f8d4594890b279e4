"""The collective pass over every cell (``repro_torch.parallel.placements``,
``launch.dryrun``), on the CPU.

* Placements: every unskipped cell of every arch but VGG-16, on both
  production meshes, under ``base`` and under the variants whose knobs the
  family's rules read: rank 0's local shape of every leaf of the state and
  the inputs, laid out as a DTensor on the fake group's mesh, equals
  ``Sharding.shard_shape``.
* (a) every SMOKE cell's collective pass, called on a one-device mesh
  (``run_cell`` runs none there), counts no collective; the SMOKE cells
  whose K3 head widths the card has no pair for (DeepSeek-V3's 24 / 16, the
  U-Net's 8) raise, as the plain pass does.

``tests/test_torch_collectives.py`` holds the identities and each kind's
record on a three-axis mesh.
"""
import functools

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get, list_archs
from repro_torch.configs.steps import build
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.parallel import placements, variants
from repro_torch.parallel.sharding import input_shardings, named_shardings, param_shardings, state_shardings
from test_torch_collectives import smoke_pass

torch.set_num_threads(2)
FAMILY_VARIANTS = {"lm": ("base", "vocab_shard", "fsdp_all", "ep_off"), "diffusion": ("base", "spatial2d"),
                   "vision": ("base",)}
CELLS = [(a, c) for a in list_archs() if a != "vgg16" for c, cell in get(a).cells.items() if not cell.skip]
# SMOKE configs whose attention head widths K3 has no pair for
REFUSED = ("deepseek-v3-671b", "unet-sd15")


@functools.cache
def _bundle(arch: str, cell: str):
    return build(get(arch), cell)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("family", sorted(FAMILY_VARIANTS))
def test_local_shapes_are_the_shard_shapes(family, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    leaves = 0
    with placements.device_mesh(mesh) as dmesh:
        for variant in FAMILY_VARIANTS[family]:
            variants.set_variant(variant)
            try:
                for a, c in CELLS:
                    arch = get(a)
                    if arch.family != family:
                        continue
                    b = _bundle(a, c)
                    st = state_shardings(b.state, arch, mesh) if b.kind == "train" else \
                        param_shardings(b.state, arch, mesh)
                    ins = input_shardings(b.inputs, arch, arch.cells[c], mesh)
                    for path, (sh, (shape, _)) in named_shardings((st, ins), (b.state, b.inputs)).items():
                        local = tuple(placements.distribute(torch.empty(shape, device="meta"), sh, dmesh)
                                      .to_local().shape)
                        assert local == sh.shard_shape(shape), (a, c, variant, path, sh.spec, local)
                        leaves += 1
            finally:
                variants.set_variant("base")
    assert leaves > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,cell", CELLS)
def test_one_device_counts_no_collective(arch, cell):
    one = Mesh(("data", "model"), (1, 1))
    if arch in REFUSED:
        with pytest.raises(ValueError, match="head widths"):
            smoke_pass(arch, cell, one)
        assert not dist.is_initialized()
        return
    got = smoke_pass(arch, cell, one)
    coll = got.record()
    assert coll["total"] == 0 and sum(coll["counts"].values()) == 0
    assert all(len(v) == 1 for v in got.kernel_collectives.values())  # calls only
    assert not dist.is_initialized()
