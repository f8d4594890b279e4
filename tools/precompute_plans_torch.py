"""Offline bucket-lattice walk: pre-populate the port's persistent PlanStore.

The PyTorch port's twin of ``tools/precompute_plans.py``: the same lattice,
flags and printed lines, over ``repro_torch.core`` (no ``jax``, no
``repro``).  The store it fills is the port's (its rows unpickle only into
``repro_torch`` classes), so a port controller started on it serves every
lattice point with zero optimizer calls.

The replan/placement controllers key cached optima on quantised operating
points (link-rate bands x per-ES compute bands -- see
``repro_torch.core.replan``), and each band's plan is optimised against the band's
*representative* rates, never the raw measurements.  Operating points are
therefore enumerable offline: this tool walks a lattice of band shifts around
the nominal point and calls :meth:`ReplanController.prime` on each, filling a
:class:`~repro.core.planstore.PlanStore` with exactly the entries a live
controller would compute on demand -- same keys (the controller's own
fingerprint/bucket logic, not a reimplementation), same bit-identical plans.

``--smoke`` builds a small warm store; a controller started against that
file serves every lattice point with zero optimizer calls
(``tests/test_torch_scripts_planner.py`` pins this, and ``chip_smoke.py``
phase 17 serves each of its plans through K1 on the card).

The lattice covers the drift modes the benchmarks exercise: uniform link-band
shifts (channel-wide congestion, ``--link-shifts``) crossed with band shifts
of the *last* secondary's compute (the straggler scenario of
``benchmarks/straggler_sweep.py``, ``--compute-shifts``).  Negative compute
shifts are slower-than-nominal bands (the compute grid is nominal-anchored,
round-to-nearest; the link grid is floor-based -- integer shifts are valid
points on both).

Usage::

    python tools/precompute_plans_torch.py --store plans.sqlite --smoke
    python tools/precompute_plans_torch.py --store plans.sqlite \
        --link-shifts -3 -2 -1 0 1 --compute-shifts -4 -3 -2 -1 0
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import (  # noqa: E402
    AGX_XAVIER,
    SCHEMES,
    CollabTopology,
    Link,
    PlanStore,
    ReplanConfig,
    ReplanController,
)
from repro_torch.models import vgg  # noqa: E402

# The demo cluster of tools/precompute_plans.py: small enough that a full
# lattice optimises in seconds (closed-form objective), real enough that
# plans differ across bands.  Equal to the JAX tool's, so the two stores hold
# the same key texts.
NOMINAL_BPS = 120e6


def demo_net():
    return vgg.VGGConfig(img_res=64, width_mult=0.125, num_classes=10).geom()


def demo_topology() -> CollabTopology:
    return CollabTopology(
        host="e0",
        secondaries=("a", "b"),
        platforms={"e0": AGX_XAVIER, "a": AGX_XAVIER, "b": AGX_XAVIER},
        default_link=Link(NOMINAL_BPS),
    )


def demo_config() -> ReplanConfig:
    return ReplanConfig(use_simulator=False, alpha=1.0, hysteresis=1, bucket_frac=0.5)


def demo_scheme_config() -> ReplanConfig:
    """The full-vocabulary twin of :func:`demo_config`: per-stage scheme
    search needs the DES objective, and the vocabulary is part of the cache
    fingerprint, so this lattice is disjoint from the halo-only one by
    construction -- the two warm stores coexist in the same file."""
    return ReplanConfig(
        use_simulator=True, n_tasks=1, alpha=1.0, hysteresis=1,
        bucket_frac=0.5, schemes=SCHEMES,
    )


def lattice_keys(
    controller: ReplanController,
    link_shifts: list[int],
    compute_shifts: list[int],
) -> list[tuple]:
    """Bucket keys of the (uniform link shift) x (straggler compute shift)
    lattice around the controller's nominal operating point.  Built by
    shifting the controller's *own* seed key, so grid conventions (floor vs
    nearest, band anchors) can never drift from the live path."""
    base_links, base_compute = controller._active
    straggler = controller.nominal.secondaries[-1]
    keys = []
    for dl in link_shifts:
        links = tuple(sorted((pair, b + dl) for pair, b in base_links))
        for dc in compute_shifts:
            compute = tuple(
                sorted(
                    (es, nom, b + dc if es == straggler else b)
                    for es, nom, b in base_compute
                )
            )
            keys.append((links, compute))
    return keys


def precompute(
    store_path: str,
    link_shifts: list[int],
    compute_shifts: list[int],
    net=None,
    topology: CollabTopology | None = None,
    config: ReplanConfig | None = None,
) -> dict:
    """Walk the lattice into ``store_path``; returns a summary dict.

    Idempotent and incremental: points already in the store are store hits
    (zero optimizer calls), so re-running after widening the shift ranges
    only pays for the new points."""
    t0 = time.perf_counter()
    with PlanStore(store_path) as store:
        controller = ReplanController(
            net if net is not None else demo_net(),
            topology if topology is not None else demo_topology(),
            config if config is not None else demo_config(),
            store=store,
        )
        keys = lattice_keys(controller, link_shifts, compute_shifts)
        for key in keys:
            controller.prime(key)
        summary = dict(
            store=store.path,
            lattice_points=len(keys),
            optimizer_calls=controller.optimizer_calls,
            already_stored=controller.cache.store_hits,
            store_entries=len(store),
            elapsed_s=time.perf_counter() - t0,
        )
    return summary


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", default="plans.sqlite", help="PlanStore file to fill")
    ap.add_argument(
        "--smoke", action="store_true", help="CI-sized lattice (3 x 3 points)"
    )
    ap.add_argument(
        "--link-shifts", type=int, nargs="+", default=[-3, -2, -1, 0, 1],
        help="uniform band shifts applied to every link (0 = nominal band)",
    )
    ap.add_argument(
        "--compute-shifts", type=int, nargs="+", default=[-4, -3, -2, -1, 0],
        help="band shifts of the last secondary's compute (straggler axis)",
    )
    args = ap.parse_args(argv)
    link_shifts = [-1, 0, 1] if args.smoke else args.link_shifts
    compute_shifts = [-2, -1, 0] if args.smoke else args.compute_shifts
    out = precompute(args.store, link_shifts, compute_shifts)
    # Scheme-vocabulary lattice: same link bands, nominal compute (scheme
    # choice is most sensitive to the channel; the straggler axis is covered
    # by the halo-only lattice above).  Idempotent like the base walk.
    scheme = precompute(
        args.store, link_shifts, [0], config=demo_scheme_config()
    )
    for label, o in (("halo lattice", out), ("scheme lattice", scheme)):
        print(
            f"{o['store']} [{label}]: {o['lattice_points']} lattice points, "
            f"{o['optimizer_calls']} optimised, {o['already_stored']} already "
            f"stored, {o['store_entries']} entries total "
            f"({o['elapsed_s']:.2f}s)"
        )
    return {"base": out, "scheme": scheme}


if __name__ == "__main__":
    main()
