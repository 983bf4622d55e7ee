"""AdamW with an f32 master copy, in PyTorch.

Counterpart of ``repro/train/optimizer.py``: the same state (``step``
int32, ``m``, ``v`` and ``master`` f32 trees shaped as the params), the
same schedule (linear warmup on the step before it is incremented), the
same clip by the global norm, bias correction and decoupled weight decay
inside the lr product; the new params are the master copy cast to each
leaf's dtype. Plain functions on tensors under ``torch.no_grad``
(``torch.optim.AdamW`` keeps neither the master copy nor this state).

Params, grads and states are nested dicts of tensors. Unlike the JAX
functions, ``apply_updates`` updates ``state`` IN PLACE (one f32 copy of
``m``, ``v`` and ``master`` is 12 bytes a parameter, 18.5 GB for
qwen2-1.5b) and returns the same dict.

``state_specs`` gives the states' partition specs (ZeRO-1), as the JAX
function does: each inherits its parameter's spec (``models.sharding``)
and shards its first replicated dim that ``zero_size`` divides over the
data axis, so each data-parallel rank owns a slice of m, v and master.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of tensors (and of ``rest``,
    trees of the same keys). Anything but a dict or a tensor raises, so
    that a serving params object's ``"layers"`` list (``api.prepare``)
    never reaches the optimizer or a checkpoint."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a training tree holds dicts of tensors, got "
                        f"{type(tree).__name__} (pass params without the "
                        "serving views of api.prepare)")
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The tensors of ``tree`` in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def init_state(params):
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {
        "step": step,
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                   copy=True), params),
    }


def state_specs(param_specs, params_shape=None, zero_axis: str = "data",
                zero_size: int = 16):
    """Optimizer-state specs (ZeRO-1): inherit the param spec and
    additionally shard the first replicated *divisible* dim over
    ``zero_axis``. ``params_shape`` (a matching tree of tensors, meta ones
    do) enables the divisibility check; without it no widening happens.
    Specs are ``models.sharding``'s tuples; ``step`` takes the empty one."""

    def _axes_used(spec):
        used = set()
        for p in spec:
            if p is None:
                continue
            if isinstance(p, (tuple, list)):
                used.update(p)
            else:
                used.add(p)
        return used

    def widen(spec, leaf=None):
        if zero_axis is None or leaf is None or zero_axis in _axes_used(spec):
            return spec
        parts = list(spec)
        for i, p in enumerate(parts):
            if p is None and leaf.shape[i] % zero_size == 0 \
                    and leaf.shape[i] > 0:
                parts[i] = zero_axis
                return tuple(parts)
        return spec

    def walk(specs, shapes):
        if isinstance(specs, dict):
            return {k: walk(v, shapes[k]) for k, v in specs.items()}
        return widen(specs, shapes)

    wide = param_specs if params_shape is None \
        else walk(param_specs, params_shape)
    return {
        "step": (),
        "m": wide,
        "v": wide,
        "master": wide,
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32."""
    return torch.stack([x.float().square().sum()
                        for x in leaves(tree)]).sum().sqrt()


def _as_state(g, m):
    """A DTensor gradient in its state's placements (ZeRO-1: a gradient
    that is a partial sum over the data axis is reduce-scattered onto the
    rank's slice of the state); a plain one as it is."""
    placements = getattr(m, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(m.device_mesh, placements)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig = AdamWConfig()):
    """Returns (new_params, state): ``state`` updated in place. Grads may
    be bf16; the math is f32, leaf by leaf. DTensor grads are first laid
    out as their state (``_as_state``); the new params keep the state's
    placements, and a sharded step gathers them back to the params'
    specs (``models.tp.respec``)."""
    grads = tree_map(_as_state, grads, state["m"])
    lr = _schedule(cfg, state["step"])
    state["step"] += 1
    step = state["step"].float()
    scale = torch.clamp(cfg.grad_clip / (global_norm(grads) + 1e-9),
                        max=1.0)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step

    def upd(g, m, v, master):
        gf = g.float() * scale
        m.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(gf.square_(), alpha=1 - cfg.b2)
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        master.sub_(lr * ((m / b1c).div_(denom)
                          .add_(master, alpha=cfg.weight_decay)))

    tree_map(upd, grads, state["m"], state["v"], state["master"])
    new_params = tree_map(lambda mp, p: mp.to(p.dtype, copy=True),
                          state["master"], params)
    return new_params, state


def loss_and_grads(loss_fn, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` over fresh leaves that
    require grad (the caller's tensors are not touched), the grads from
    ``torch.autograd.grad``, in params' tree and dtypes."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(loss_fn, cfg: AdamWConfig = AdamWConfig()):
    """loss_fn(params, batch) -> scalar. Returns step(params, state, batch)
    -> (params, state, loss), the state updated in place."""

    def step(params, state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        params, state = apply_updates(params, grads, state, cfg)
        return params, state, loss

    return step
