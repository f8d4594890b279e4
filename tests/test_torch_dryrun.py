"""The port's cost accounting and dry run (``repro_torch.launch.op_cost``,
``launch.dryrun``) against the JAX package's (``repro/launch/hlo_cost.py``,
``dryrun.py``), on the CPU.

* ``op_cost`` against ``analyze_hlo`` exactly: twins of
  ``tests/test_hlo_cost.py``'s dot, conv and L-layer loop; one SMOKE cell of
  each kind against the single-device compiled step, equal, or apart by the
  terms this file computes and ROADMAP.md §3 names: K3's causal half (JAX's
  einsums weigh every pair, then mask), and in ViT's train step K3's plain
  backward, which recomputes the scores (one product over every pair more
  than the einsums' backward).  Both sides rematerialise each block alike:
  XLA's recompute and ``torch.utils.checkpoint``'s (which stops once the
  saved activations are rebuilt) both skip fc2, whose output the backward
  does not read.
* K1 depthwise counted with its groups (the flop counter's conv backward
  counts a depthwise weight gradient C times over); no kernel's plain
  internals counted.
* ``run_cell`` at the SMOKE configs of every kind: ``ok``; a K3 head width
  the card has no pair for (the SMOKE U-Net's D = 8): ``error``; ``main``
  writes its record only under ``build/dryrun_torch/``, which git ignores.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get as jget
from repro.configs import steps as jsteps
from repro.launch.hlo_cost import analyze_hlo
from repro_torch.configs import get
from repro_torch.configs.steps import _shrink, _zeros, build
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.conv2d import conv2d_cuda
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import Mesh

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def _jax_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _counted(fn, *args) -> op_cost.OpCost:
    with op_cost.counting(*args) as cost:
        fn(*args)
    return cost


def _sds(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_dot_flops_equal_analyze_hlo():
    got = _counted(lambda a, b: a @ b, torch.empty(128, 256, device="meta"), torch.empty(256, 512, device="meta"))
    assert got.flops == _jax_flops(lambda a, b: a @ b, _sds((128, 256)), _sds((256, 512))) == 2 * 128 * 256 * 512
    assert got.bytes_accessed == 4 * (128 * 256 + 256 * 512 + 128 * 512)


@pytest.mark.parametrize("layers", [2, 8, 32])
def test_layer_loop_flops_equal_analyze_hlo(layers):
    def jf(x, ws):
        return jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, ws)[0]

    def tf(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    got = _counted(tf, torch.empty(128, 256, device="meta"), torch.empty(layers, 256, 256, device="meta"))
    assert got.flops == _jax_flops(jf, _sds((128, 256)), _sds((layers, 256, 256))) == layers * 2 * 128 * 256 * 256


def test_conv_flops_equal_analyze_hlo():
    def jf(a, b):
        return jax.lax.conv_general_dilated(a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    x, w = torch.randn(2, 16, 16, 8), torch.randn(3, 3, 8, 16)
    got = _counted(lambda a, b: conv2d_cuda(a, b, padding=1), x, w)
    assert got.flops == got.kernel_flops == _jax_flops(jf, _sds((2, 16, 16, 8)), _sds((3, 3, 8, 16)))
    assert got.library_flops == 0  # the plain version on the CPU is the kernel's stand-in, not counted
    assert got.calls == {"K1": {((2, 16, 16, 8), (3, 3, 8, 16), 1, 1, 1, False, "float32", False): 1}}


def test_depthwise_conv_counts_its_groups_and_no_plain_internals():
    from torch.utils.flop_counter import FlopCounterMode

    n, h, c, k = 2, 12, 32, 3
    x = torch.randn(n, h, h, c, requires_grad=True)
    w = torch.randn(k, k, 1, c, requires_grad=True)

    def step(x, w):
        y = conv2d_cuda(x, w, stride=2, padding=1, groups=c)
        torch.autograd.grad(y.square().sum(), (x, w))

    one = 2.0 * n * 6 * 6 * k * k * c  # a forward: output pixels x taps x channels, no C-fold
    got = _counted(step, x, w)
    assert got.kernel_flops == one  # K1's forward; the strided input gradient is the library's
    with FlopCounterMode(display=False) as counter:
        step(x, w)
    counts = counter.get_flop_counts()["Global"]
    lib_bwd = sum(v for op, v in counts.items() if "convolution_backward" in str(op))
    assert got.library_flops == 2 * one  # dgrad + dW from the shapes, with the groups
    assert lib_bwd == one + c * one  # the counter's dW ignores them: C times over
    # at stride 1 the input gradient is K1 again (on the flipped filter), counted from its call
    with op_cost.counting(x, w) as cost:
        torch.autograd.grad(conv2d_cuda(x, w, padding=1, groups=c).sum(), (x, w))
    assert set(cost.calls) == {"K1", "K1 dgrad"} and cost.kernel_flops == 2 * (2.0 * n * h * h * k * k * c)


def test_attention_counts_the_pairs_it_weighs():
    q, k, v = (torch.randn(2, 4, 9, 16) for _ in range(3))
    got = _counted(lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v)
    assert got.library_flops == 0 and got.kernel_flops == 2.0 * 2 * 4 * (9 * 10 // 2) * 32
    assert op_cost.attention_pairs(9, 9, True) == sum(min(9, t + 1) for t in range(9))
    assert op_cost.attention_pairs(12, 5, True) == sum(min(5, t + 1) for t in range(12))
    assert op_cost.attention_pairs(3, 5, True) == sum(min(5, t + 1) for t in range(3))


def _smoke_cost(arch: str, cell: str) -> op_cost.OpCost:
    a = get(arch)
    b = build(a, cell, smoke=True)
    state = _zeros(b.state, "meta")
    inputs = {k: _zeros(v, "meta") for k, v in b.inputs.items()}
    if b.kind == "decode":
        inputs["index"] = _shrink(a.cells[cell]).meta["seq_len"] - 1
    with op_cost.counting(state, inputs) as cost:
        b.fn(state, **inputs)
    return cost


def _jax_smoke_flops(arch: str, cell: str) -> float:
    b = jsteps.build(jget(arch), cell, smoke=True)
    return _jax_flops(b.fn, b.state, *b.input_list)


def _causal_half(cost) -> float:
    """JAX's attention products over the pairs K3's causal mask skips."""
    return sum(n * 2.0 * b * h * (t * s - op_cost.attention_pairs(t, s, causal)) * (d + dv)
               for ((b, h, t, d), s, _, causal, dv), n in cost.calls.get("K3", {}).items())


def _vit_train_terms(cfg, batch: int) -> float:
    """JAX minus the port in ViT's train step: less the scores K3's plain
    backward recomputes, once a block.  Each block's remat recompute (its
    forward products but fc2, and K3's forward once more) is on both
    sides."""
    t, d, h = cfg.n_tokens, cfg.d_model, cfg.n_heads
    scores = 2.0 * batch * h * t * t * (d // h)
    return -cfg.n_layers * scores


@pytest.mark.parametrize("arch,cell", [("vit-l16", "serve_b1"), ("qwen3-4b", "prefill_32k"),
                                       ("qwen3-4b", "decode_32k"), ("dit-xl2", "gen_fast"), ("vit-l16", "cls_224")])
def test_smoke_cell_flops_match_analyze_hlo(arch, cell):
    cost = _smoke_cost(arch, cell)
    want = _jax_smoke_flops(arch, cell)
    terms = _causal_half(cost)
    if (arch, cell) == ("vit-l16", "cls_224"):
        terms += _vit_train_terms(get(arch).smoke_cfg, _shrink(get(arch).cells[cell]).meta["batch"])
    assert cost.flops + terms == want, (cost.flops, terms, want)
    assert (terms > 0) == (cell == "prefill_32k") and (terms < 0) == (cell == "cls_224")
    assert cost.flops > cost.kernel_flops > 0 and cost.bytes_accessed > 0 and cost.peak_live_bytes > 0


# a production-shaped mesh that the SMOKE cells' batch of 2 and 64-pixel
# images divide (the production meshes' 16-way data axis does not)
SMOKE_MESH = Mesh(("pod", "data", "model"), (2, 2, 2))


def _smoke_arch(name: str):
    a = get(name)
    return dataclasses.replace(a, cfg=a.smoke_cfg, cells={k: _shrink(c) for k, c in a.cells.items() if not c.skip})


@pytest.mark.parametrize("arch,cell", [("vit-l16", "serve_b128"), ("vit-l16", "cls_224"), ("qwen3-4b", "train_4k"),
                                       ("qwen3-4b", "prefill_32k"), ("moonshot-v1-16b-a3b", "decode_32k"),
                                       ("dit-xl2", "gen_fast"), ("dit-xl2", "train_256"),
                                       ("efficientnet-b7", "serve_b1")])
def test_run_cell_at_smoke_configs_is_ok(arch, cell):
    rec = dryrun.run_cell(_smoke_arch(arch), cell, mesh=SMOKE_MESH, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "pod2x2x2"
    mem, cost = rec["memory"], rec["cost"]
    assert 0 < mem["argument_size_in_bytes"] <= mem["argument_allocated_bytes"]
    assert mem["output_size_in_bytes"] > 0 and cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert rec["peak_live_bytes"] > 0 and rec["trace_s"] > 0
    assert "K3" in rec["kernels"] or arch == "efficientnet-b7"
    json.dumps(rec)


def test_one_device_mesh_holds_every_byte():
    a = _smoke_arch("vit-l16")
    rec = dryrun.run_cell(a, "cls_224", mesh=Mesh(("data", "model"), (1, 1)), verbose=False)
    b = build(a, "cls_224")
    leaves = [s for tree in (b.state, b.inputs) for s in _leaves(tree)]
    assert rec["mesh"] == "pod1x1"
    assert rec["memory"]["argument_size_in_bytes"] == sum(_nbytes(s) for s in leaves)
    assert rec["memory"]["argument_allocated_bytes"] == sum(max(512, -(-_nbytes(s) // 512) * 512) for s in leaves)


def _leaves(tree):
    if isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[1], torch.dtype):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items for x in _leaves(v)]


def _nbytes(spec) -> int:
    n = spec[1].itemsize
    for d in spec[0]:
        n *= d
    return n


def test_a_head_width_the_card_refuses_is_an_error():
    rec = dryrun.record_cell(_smoke_arch("unet-sd15"), "gen_fast", mesh=SMOKE_MESH, verbose=False)  # D = 8
    assert rec["status"] == "error" and "head widths" in rec["error"]
    rec = dryrun.record_cell(_smoke_arch("dit-xl2"), "gen_fast", mesh=SMOKE_MESH, verbose=False)
    assert rec["status"] == "ok"


def test_skipped_cell_is_recorded():
    rec = dryrun.run_cell("qwen3-4b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and rec["skip_reason"]


def test_main_writes_its_record_under_the_ignored_directory(capsys):
    assert dryrun.RESULTS_DIR == ROOT / "build" / "dryrun_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()
    path = dryrun.RESULTS_DIR / "qwen3-4b__train_4k__pod16x16.json"
    before = path.stat().st_mtime_ns if path.exists() else None
    assert dryrun.main(["--arch", "qwen3-4b", "--cell", "train_4k"]) == 0
    rec = json.loads(path.read_text())
    assert path.stat().st_mtime_ns != before and rec["status"] == "ok" and rec["cell"] == "train_4k"
    assert rec["kernels"]["K3"][0][1] == 2 * get("qwen3-4b").cfg.n_layers  # remat: each layer's K3 twice
    assert "all cells ok" in capsys.readouterr().out
