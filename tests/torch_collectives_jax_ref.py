"""The JAX side of tests/test_torch_collectives.py's collective counts.

    python tests/torch_collectives_jax_ref.py ARCH CELL DATA MODEL [DTYPE]

lowers and compiles JAX's SMOKE step of ARCH / CELL (``steps.build(...,
smoke=True)``, bfloat16 unless DTYPE says float32) for a (DATA, MODEL)
("data", "model") mesh of forced host devices, with ``in_shardings`` and
``out_shardings`` as ``repro.launch.dryrun.run_cell`` pins them, and prints
one JSON object: ``analyze_hlo``'s ``per_collective`` and
``collective_counts``, and every collective-permute's result type with its
count.  ``repro.launch.dryrun`` itself is not imported: it forces 512
devices and a compilation cache outside the checkout.
"""
import json
import os
import re
import sys

ARCH, CELL, DATA, MODEL = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
DTYPE = sys.argv[5] if len(sys.argv) > 5 else "bfloat16"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={DATA * MODEL}"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.configs import get  # noqa: E402
from repro.configs.steps import _shrink, build  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.parallel.sharding import input_shardings, param_shardings, state_shardings  # noqa: E402


def out_shardings(bundle, mesh, state_sh, in_sh):
    """``repro.launch.dryrun._out_shardings``."""
    def rep():
        return NamedSharding(mesh, P())

    if bundle.kind == "train":
        metrics = jax.eval_shape(bundle.fn, bundle.state, *bundle.input_list)[1]
        return state_sh, jax.tree_util.tree_map(lambda _: rep(), metrics)
    if bundle.kind == "prefill":
        return NamedSharding(mesh, P(None, None, "model"))
    if bundle.kind == "decode":
        return NamedSharding(mesh, P(None, "model")), in_sh["cache"]
    if bundle.kind == "gen":
        return in_sh["latents"]
    return rep()


def main() -> None:
    arch = get(ARCH)
    mesh = Mesh(np.array(jax.devices()).reshape(DATA, MODEL), ("data", "model"))
    bundle = build(arch, CELL, smoke=True, dtype=getattr(jnp, DTYPE))
    cell = _shrink(arch.cells[CELL])
    in_sh = input_shardings(bundle.inputs, arch, cell, mesh)
    state_sh = state_shardings(bundle.state, arch, mesh) if bundle.kind == "train" else \
        param_shardings(bundle.state, arch, mesh)
    jitted = jax.jit(bundle.fn, in_shardings=(state_sh, *[in_sh[k] for k in bundle.inputs]),
                     out_shardings=out_shardings(bundle, mesh, state_sh, in_sh))
    with mesh:
        hlo = jitted.lower(bundle.state, *bundle.input_list).compile().as_text()
    hc = analyze_hlo(hlo)
    permutes: dict = {}
    for line in hlo.splitlines():
        m = re.search(r"=\s+(\S+)\s+collective-permute(-start)?\(", line)
        if m:
            permutes[m.group(1)] = permutes.get(m.group(1), 0) + 1
    print(json.dumps({"per_collective": hc.per_collective, "collective_counts": hc.collective_counts,
                      "permutes": permutes}))


if __name__ == "__main__":
    main()
