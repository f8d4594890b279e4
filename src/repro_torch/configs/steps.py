"""Step builders (twin of ``repro/configs/steps.py``): (arch, cell) -> step
function + the shapes and types of its inputs.

JAX's builder returns abstract pytrees (``jax.eval_shape``) for its dry-run;
the port has no dry-run, so its bundle holds ``(shape, dtype)`` pairs, taken
from an init on the ``meta`` device.  Every kind of every family is built:
LM ``train``, ``prefill`` and ``decode``, vision ``train`` and ``serve``,
diffusion ``train`` and ``gen`` (a DDIM sampler over the backbone).

A train step is a plain function ``step((params, opt, n), **batch) ->
((params, opt, n + 1), metrics)`` (the LM's metrics are its ``loss_fn``'s:
``ce``, ``load_balance``, ``mtp`` where the config has the head, ``total``;
the others' ``{"loss": loss}``): the model's loss, the gradients of every
parameter leaf by ``torch.autograd.grad`` (a leaf the loss does not reach
gets zeros, as JAX's gradient gives it), then
:func:`~repro_torch.optim.adamw_update` at ``warmup_cosine(n)``.  It returns
new tensors and leaves its input state intact.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models import dit, unet
from ..models import transformer_lm as lm
from ..models.common import tree_leaves, tree_map, tree_unflatten
from ..optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine
from ..parallel.variants import get_variant
from .base import Arch, Cell

__all__ = ["StepBundle", "build", "abstract_params", "abstract_state", "realize"]


@dataclass
class StepBundle:
    """One (arch, cell): the step, and the shapes its arguments take."""

    fn: Callable  # fn(params or (params, opt, n), *inputs)
    state: Any  # the parameters (train: (params, opt, n)) as a tree of (shape, dtype)
    inputs: dict[str, Any]  # name -> (shape, dtype), or a tree of them (a KV or latent cache)
    kind: str
    cfg: Any  # the model config the step runs (the cell's resolution applied): its parameters' shapes


def _spec(t: torch.Tensor) -> tuple[tuple[int, ...], torch.dtype]:
    return tuple(t.shape), t.dtype


def abstract_params(arch: Arch, cfg, dtype) -> Any:
    return tree_map(_spec, arch.module.init(torch.Generator(), cfg, dtype, device="meta"))


def abstract_state(arch: Arch, cfg, dtype, opt_cfg: AdamWConfig) -> tuple:
    """A train step's state ``(params, opt, n)`` as (shape, dtype) trees."""
    params = arch.module.init(torch.Generator(), cfg, dtype, device="meta")
    return tree_map(_spec, params), tree_map(_spec, adamw_init(params, opt_cfg)), ((), torch.int32)


def _opt_cfg_for(arch: Arch) -> AdamWConfig:
    # bf16 moments for the very large configs, as JAX's builder takes them
    if arch.name.startswith("deepseek"):
        return AdamWConfig(moment_dtype=torch.bfloat16)
    return AdamWConfig()


def _grads(loss_of: Callable, params) -> tuple[torch.Tensor, Any, Any]:
    """(loss, aux, gradient tree) of ``loss_of(params) -> (loss, aux)``: each
    leaf's gradient by ``torch.autograd.grad``, zeros where the loss does not
    reach the leaf."""
    with torch.enable_grad():
        tracked = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, aux = loss_of(tracked)
        leaves = tree_leaves(tracked)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def _lm_train(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    opt_cfg = _opt_cfg_for(arch)

    def step(state, tokens, labels):
        params, opt, n = state
        _, metrics, grads = _grads(lambda p: lm.loss_fn(p, cfg, tokens, labels), params)
        params, opt = adamw_update(grads, opt, params, opt_cfg, warmup_cosine(n))
        return (params, opt, n + 1), {k: v.detach() for k, v in metrics.items()}

    b, s = cell.meta["global_batch"], cell.meta["seq_len"]
    return StepBundle(fn=step, state=abstract_state(arch, cfg, dtype, opt_cfg),
                      inputs={"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}, cfg=cfg, kind="train")


def _lm_prefill(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    def step(params, tokens):
        logits, _ = lm.forward(params, cfg, tokens)
        return logits

    b, s = cell.meta["global_batch"], cell.meta["seq_len"]
    return StepBundle(fn=step, state=abstract_params(arch, cfg, dtype),
                      inputs={"tokens": ((b, s), torch.int32)}, cfg=cfg, kind="prefill")


def _lm_decode(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    b, s = cell.meta["global_batch"], cell.meta["seq_len"]

    def step(params, cache, tokens, index):
        return lm.decode_step(params, cfg, cache, tokens, index)

    cache = tree_map(_spec, lm.init_cache(cfg, b, s, dtype, device="meta"))
    return StepBundle(fn=step, state=abstract_params(arch, cfg, dtype),
                      inputs={"cache": cache, "tokens": ((b, 1), torch.int32), "index": ((), torch.int32)},
                      cfg=cfg, kind="decode")


def _adapt_vision_cfg(arch: Arch, cfg, img_res: int):
    cfg = dataclasses.replace(cfg, img_res=img_res)
    if arch.family == "vision" and hasattr(cfg, "window") and img_res == 384:
        # Swin finetunes at 384 with window 12 (arXiv:2103.14030 §4.1)
        cfg = dataclasses.replace(cfg, window=12)
    return cfg


def _vision_train(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    cfg = _adapt_vision_cfg(arch, cfg, cell.meta["img_res"])
    opt_cfg = _opt_cfg_for(arch)

    def step(state, images, labels):
        params, opt, n = state
        # the stream's float32 images in the parameters' type
        images = images.to(dtype)
        loss, _, grads = _grads(lambda p: arch.module.loss_fn(p, cfg, images, labels), params)
        params, opt = adamw_update(grads, opt, params, opt_cfg, warmup_cosine(n))
        return (params, opt, n + 1), {"loss": loss}

    b, r = cell.meta["batch"], cell.meta["img_res"]
    return StepBundle(fn=step, state=abstract_state(arch, cfg, dtype, opt_cfg),
                      inputs={"images": ((b, r, r, 3), dtype), "labels": ((b,), torch.int32)}, cfg=cfg, kind="train")


def _vision_serve(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    cfg = _adapt_vision_cfg(arch, cfg, cell.meta["img_res"])

    def step(params, images):
        return arch.module.apply(params, cfg, images)

    b, r = cell.meta["batch"], cell.meta["img_res"]
    return StepBundle(fn=step, state=abstract_params(arch, cfg, dtype),
                      inputs={"images": ((b, r, r, 3), dtype)}, cfg=cfg, kind="serve")


def _diff_cfg(arch: Arch, cfg, img_res: int):
    return dataclasses.replace(cfg, img_res=img_res)


def _diffusion_cond_specs(arch: Arch, cfg, b, dtype):
    if arch.module is dit:
        return {"cond": ((b,), torch.int32)}
    return {"cond": ((b, cfg.ctx_len, cfg.ctx_dim), dtype)}


def _diffusion_apply(arch: Arch, cfg, params, lat, t, cond):
    if arch.module is dit:
        return dit.apply(params, cfg, lat, t, cond)[..., : cfg.latent_ch]
    return unet.apply(params, cfg, lat, t, cond)


def _diffusion_train(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    cfg = _diff_cfg(arch, cfg, cell.meta["img_res"])
    opt_cfg = _opt_cfg_for(arch)
    n_steps = cell.meta.get("steps", 1000)

    def loss_fn(params, latents, t, cond, noise):
        # cosine-ish alpha schedule in float32, cast to the latents' type;
        # eps-prediction MSE (the DDPM objective) in float32, as JAX's
        a = torch.cos((0.5 * math.pi) * (t.float() / n_steps)) ** 2
        a = a[:, None, None, None].to(latents.dtype)
        x_t = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
        pred = _diffusion_apply(arch, cfg, params, x_t, t, cond)
        return torch.mean(torch.square(pred.float() - noise.float())), None

    def step(state, latents, t, cond, noise):
        params, opt, n = state
        # the stream's float32 latents, noise and text context in the parameters' type
        latents, noise = latents.to(dtype), noise.to(dtype)
        if cond.is_floating_point():
            cond = cond.to(dtype)
        loss, _, grads = _grads(lambda p: loss_fn(p, latents, t, cond, noise), params)
        params, opt = adamw_update(grads, opt, params, opt_cfg, warmup_cosine(n))
        return (params, opt, n + 1), {"loss": loss}

    b, lr = cell.meta["batch"], cfg.latent_res
    lat = ((b, lr, lr, cfg.latent_ch), dtype)
    inputs = {"latents": lat, "t": ((b,), torch.int32), **_diffusion_cond_specs(arch, cfg, b, dtype), "noise": lat}
    return StepBundle(fn=step, state=abstract_state(arch, cfg, dtype, opt_cfg), inputs=inputs, cfg=cfg, kind="train")


def ddim_timesteps(n_train: int, n_steps: int) -> list[int]:
    """The sampler's timesteps, JAX's ``linspace(n_train - 1, 1, n_steps)``
    taken in float32 and truncated to int32."""
    return torch.linspace(n_train - 1, 1, n_steps, dtype=torch.float32).to(torch.int32).tolist()


def _alpha(t: int, n_train: int) -> torch.Tensor:
    """``cos(0.5 pi t / n_train)^2`` in float32, as a 0-dim CPU tensor."""
    x = torch.tensor(t, dtype=torch.float32) / n_train
    return torch.cos((0.5 * math.pi) * x) ** 2


def _diffusion_gen(arch: Arch, cfg, cell: Cell, dtype) -> StepBundle:
    cfg = _diff_cfg(arch, cfg, cell.meta["img_res"])
    if get_variant().diffusion_spatial2d and hasattr(cfg, "attn_f32"):
        # JAX's serving variant: SD-style low-precision softmax
        cfg = dataclasses.replace(cfg, attn_f32=False)
    n_steps = cell.meta["steps"]
    n_train = 1000

    def sample(params, latents, cond):
        """DDIM sampler: ``n_steps`` forwards of the backbone.  Each update
        runs in float32 and is then cast to the latents' type, as JAX's: its
        ``jnp.sqrt(1 - a)`` is a float32 array (not a weak scalar), so it
        promotes a bfloat16 eps and latent to float32."""
        ts = ddim_timesteps(n_train, n_steps)
        lat = latents
        for t, t_next in zip(ts, ts[1:] + [0]):
            tb = torch.full((lat.shape[0],), t, dtype=torch.int32, device=lat.device)
            eps = _diffusion_apply(arch, cfg, params, lat, tb, cond).float()
            a, an = _alpha(t, n_train), _alpha(t_next, n_train)
            # the float32 coefficients as Python floats: exact, and no host tensor meets the card's
            s1a, sa, san, s1an = (torch.sqrt(v).item() for v in (1 - a, a, an, 1 - an))
            x0 = (lat.float() - s1a * eps) / sa
            lat = (san * x0 + s1an * eps).to(latents.dtype)
        return lat

    b = cell.meta["batch"]
    lr = cfg.latent_res
    cond = _diffusion_cond_specs(arch, cfg, b, dtype)
    return StepBundle(fn=sample, state=abstract_params(arch, cfg, dtype),
                      inputs={"latents": ((b, lr, lr, cfg.latent_ch), dtype), **cond}, cfg=cfg, kind="gen")


_BUILDERS = {
    ("lm", "train"): _lm_train,
    ("lm", "prefill"): _lm_prefill,
    ("lm", "decode"): _lm_decode,
    ("vision", "train"): _vision_train,
    ("vision", "serve"): _vision_serve,
    ("diffusion", "train"): _diffusion_train,
    ("diffusion", "gen"): _diffusion_gen,
}


def build(arch: Arch, cell_name: str, *, smoke: bool = False, dtype=None) -> StepBundle:
    cell = arch.cells[cell_name]
    if cell.skip:
        raise ValueError(f"{arch.name}/{cell_name} is skipped: {cell.skip}")
    if (arch.family, cell.kind) not in _BUILDERS:
        # JAX's ``build`` has none either: VGG-16, the paper's model, is served
        # through run_plan and launch/serve.py (ROADMAP.md)
        raise NotImplementedError(f"{arch.name}/{cell_name}: configs.steps has no {arch.family} {cell.kind} step, "
                                  f"as JAX's has none (served through run_plan; ROADMAP.md)")
    cfg = arch.smoke_cfg if smoke else arch.cfg
    if smoke:
        cell = _shrink(cell)
    if dtype is None:
        dtype = torch.float32 if smoke else torch.bfloat16
    return _BUILDERS[(arch.family, cell.kind)](arch, cfg, cell, dtype)


def realize(arch: Arch, bundle: StepBundle, gen: torch.Generator) -> tuple[Any, dict]:
    """Real (state, inputs) for a bundle on ``gen``'s device: parameters
    from the arch's init at the bundle's config (JAX's takes the arch's,
    whose DiT position table, sized for 256 x 256, does not fit train_1024's
    4096 tokens), a train bundle adding zero AdamW moments and step 0;
    random inputs -- integers below 8 (under every smoke config's classes
    and vocabulary), 0 for a scalar, floats N(0, 1) -- and zeros for a tree
    of inputs (a cache)."""
    dtype = _spec_leaves(bundle.state)[0][1]  # the parameters' type: a train state leads with them
    params = arch.module.init(gen, bundle.cfg, dtype)
    state = params
    if bundle.kind == "train":
        state = (params, adamw_init(params, _opt_cfg_for(arch)), torch.zeros((), dtype=torch.int32, device=gen.device))
    return state, {name: _random_like(spec, gen) for name, spec in bundle.inputs.items()}


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def _spec_leaves(tree) -> list:
    if _is_spec(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items for x in _spec_leaves(v)]


def _zeros(spec, device) -> Any:
    if _is_spec(spec):
        return torch.zeros(spec[0], dtype=spec[1], device=device)
    if isinstance(spec, dict):
        return {k: _zeros(v, device) for k, v in spec.items()}
    return type(spec)(_zeros(v, device) for v in spec)


def _random_like(spec, gen: torch.Generator):
    if not _is_spec(spec):  # a tree of inputs (a cache): zeros
        return _zeros(spec, gen.device)
    shape, dtype = spec
    if not dtype.is_floating_point:
        if shape == ():
            return torch.zeros((), dtype=dtype, device=gen.device)
        return torch.randint(0, 8, shape, generator=gen, device=gen.device).to(dtype)
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _shrink(cell: Cell) -> Cell:
    m = dict(cell.meta)
    if "seq_len" in m:
        m["seq_len"] = 128 if cell.kind == "decode" else 64
    for k, v in (("global_batch", 2), ("batch", 2), ("steps", 2)):
        if k in m:
            m[k] = min(m[k], v)
    if "img_res" in m:
        m["img_res"] = 64
    return Cell(cell.name, cell.kind, m, None)
