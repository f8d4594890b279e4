"""The port's receptive-field chain (``repro_torch.core.rf``: eqs. 1-4, 8-9)
against the JAX package's, on the CPU.

``RFState``, ``rf_chain``, ``input_range_paper`` and ``propagate_range`` are
pure integer and ``Fraction`` arithmetic, so every value is held ``==`` to
JAX's with its type: over VGG-16's and ViT-L/16's geometries, over chains
drawn from a seeded generator, and on the error cases.  The names
``repro_torch.core`` exports are JAX's ``core/__init__.py`` l.75-78.
"""
from fractions import Fraction

import numpy as np
import pytest

import repro.core as J
import repro.core.rf as jrf
import repro_torch.core as T
import repro_torch.core.rf as trf

RF_NAMES = ("LayerGeom", "RFState", "attn", "input_range_exact", "input_range_paper", "out_size",
            "propagate_range", "rf_chain")


def port_layers(layers):
    """The port's twin of a JAX layer chain, field for field."""
    return tuple(trf.LayerGeom(g.name, g.kind, g.k, g.s, g.p, g.c_in, g.c_out, g.heads) for g in layers)


def state_tuple(st):
    assert type(st.out) is int and type(st.jump) is int and type(st.rf) is int and type(st.sigma) is Fraction
    return st.out, st.jump, st.rf, st.sigma


def random_chain(rng, n_layers: int) -> tuple[int, list]:
    """A JAX chain of ``n_layers`` sliding windows (k 1-7, s 1-3, p 0-k//2)
    over an input tall enough that every layer keeps >= 1 output row."""
    layers = []
    for i in range(n_layers):
        k = int(rng.integers(1, 8))
        s = int(rng.integers(1, 4))
        p = int(rng.integers(0, k // 2 + 1))
        kind = ("conv", "pool", "depthwise")[int(rng.integers(0, 3))]
        layers.append(jrf.LayerGeom(f"l{i}", kind, k, s, p, 8, 8))
    rows = 1
    for g in reversed(layers):  # the least input that leaves >= 1 row, then some
        rows = (rows - 1) * g.s + g.k - 2 * g.p
        rows = max(rows, 1)
    return rows + int(rng.integers(0, 40)), layers


def chains():
    rng = np.random.default_rng(28)
    cases = [("vgg16", J.vgg16_geom().in_rows, list(J.vgg16_geom().layers)),
             ("vit_l16", J.vit_l16_geom().in_rows, list(J.vit_l16_geom().layers))]
    for i in range(12):
        rows, layers = random_chain(rng, int(rng.integers(1, 9)))
        cases.append((f"random{i}", rows, layers))
    return cases


CHAINS = chains()


def test_core_exports_the_rf_names_of_jax():
    for name in RF_NAMES:
        assert name in T.__all__ and hasattr(T, name) and hasattr(J, name), name
        assert getattr(T, name) is getattr(trf, name)
    assert T.RFState.for_input(224) == trf.RFState(224, 1, 1, Fraction(1))
    assert state_tuple(T.RFState.for_input(224)) == state_tuple(J.RFState.for_input(224))
    with pytest.raises(AttributeError):  # frozen, as JAX's
        T.RFState.for_input(1).out = 2


@pytest.mark.parametrize("name,in_rows,layers", CHAINS, ids=[c[0] for c in CHAINS])
def test_rf_chain_and_ranges_equal_jax(name, in_rows, layers):
    tl = port_layers(layers)
    states, jstates = T.rf_chain(in_rows, tl), J.rf_chain(in_rows, layers)
    assert [state_tuple(s) for s in states] == [state_tuple(s) for s in jstates]
    assert len(states) == len(layers)
    rng = np.random.default_rng(len(layers) * 1000 + in_rows)
    sizes = [in_rows] + [s.out for s in states]
    for i, (st, jst) in enumerate(zip(states, jstates)):
        o = st.out
        for lo, hi in {(1, 1), (1, o), (o, o), tuple(sorted(int(v) for v in rng.integers(1, o + 1, 2)))}:
            got = T.input_range_paper(lo, hi, st, in_rows)
            assert got == J.input_range_paper(lo, hi, jst, in_rows)
            assert all(type(v) is int for v in got)
            chain = T.propagate_range(tl, in_rows, i, (lo, hi))
            assert chain == J.propagate_range(layers, in_rows, i, (lo, hi))
            assert len(chain) == i + 2 and chain[-1] == (lo, hi)
            assert all(1 <= a <= b <= sizes[j] for j, (a, b) in enumerate(chain))


def _raised(fn, *args):
    with pytest.raises(ValueError) as exc:
        fn(*args)
    return str(exc.value)


def test_error_cases_equal_jax():
    jl = [jrf.conv("c", 3, 8, k=3, s=1, p=0), jrf.pool("p", 8, k=2, s=2)]
    tl = port_layers(jl)
    # a layer with no output row (eq. 1)
    assert _raised(T.rf_chain, 2, tl) == _raised(J.rf_chain, 2, jl)
    assert _raised(T.out_size, 2, 5, 1, 0) == _raised(J.out_size, 2, 5, 1, 0)
    # ranges outside the layer's rows, or reversed
    for layer_idx, rng in ((0, (0, 3)), (0, (4, 3)), (1, (1, 99)), (1, (2, 1))):
        assert (_raised(T.propagate_range, tl, 16, layer_idx, rng)
                == _raised(J.propagate_range, jl, 16, layer_idx, rng))
    assert _raised(T.input_range_exact, 3, 2, 3, 1, 1, 16) == _raised(J.input_range_exact, 3, 2, 3, 1, 1, 16)
    assert _raised(T.attn, "a", 10, 3) == _raised(J.attn, "a", 10, 3)
    assert T.attn("a", 1024, 16) == trf.LayerGeom("a", "attn", 1, 1, 0, 1024, 1024, 16)
