"""AdamW and its schedule on PyTorch, the reference's ``training/optimizer.py``.

The optimizer state mirrors the param tree (m and v in float32) with an
int32 ``step``. The update runs in place, leaf by leaf and in slabs of the
leading axis, so its float32 temporaries stay a few hundred MiB whatever the
leaf (the reference's jit donates the state instead). Its scalars are
float32 tensors on the state's device, as the reference's are float32
arrays: Python floats would be float64, and a CUDA tensor divided by a
Python number is multiplied by its reciprocal (two roundings).

Leaf order is the reference's: ``jax.tree.leaves`` sorts dict keys, and so
does ``named_leaves``; ``global_norm`` sums the leaves in that order.

Under a device mesh the leaves are ``DTensor``s (``launch.shardings.
train_state_sharding``: m and v laid out as their parameter). The global
norm is a ``DTensor`` reduction; the update itself runs on each rank's
local blocks, each gradient first redistributed to its parameter's layout
(a partial sum over the data axes is all-reduced there).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

SLAB_ELEMS = 1 << 26  # elements of one slab of an in-place update (256 MiB in f32)


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Any  # tree like params, float32
    v: Any
    step: torch.Tensor  # [] int32


# ------------------------------------------------------------------ trees
def named_leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += named_leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device, made by a fill (a
    tensor from a Python number would be a copy that waits for the card)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


# ------------------------------------------------------------------ optimizer
def init_opt_state(params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=named_leaves(params)[0][1].device)
    return OptState(m=zeros, v=tree_map(torch.clone, zeros), step=step)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; float32."""
    warm = torch.clamp(step.float() / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(torch.pi, step) * prog))
    scale = _f32(cfg.min_lr_ratio, step) + _f32(1.0 - cfg.min_lr_ratio, step) * cos
    return _f32(cfg.lr, step) * warm * scale


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for _, x in named_leaves(tree))
    return torch.sqrt(sq)


def _decay_mask(path: Sequence[str]) -> bool:
    """No weight decay on norms / biases / 1-D params (standard)."""
    name = "/".join(str(p) for p in path)
    return not any(s in name for s in ("norm", "bias", "b_q", "b_k", "b_v", "A_log", "D", "dt_bias"))


def _slabs(t: torch.Tensor):
    """Views of ``t`` along its leading axis, each of at most SLAB_ELEMS
    elements where the rows allow."""
    if t.dim() == 0 or t.numel() <= SLAB_ELEMS:
        return [t]
    rows = max(1, SLAB_ELEMS // (t.numel() // t.shape[0]))
    return [t[i : i + rows] for i in range(0, t.shape[0], rows)]


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping. ``params``, ``state.m`` and
    ``state.v`` are updated in place; returns (params, state', metrics)."""
    gnorm = global_norm(grads)
    if isinstance(gnorm, DTensor):
        gnorm = gnorm.full_tensor()
    clip = torch.clamp(_f32(cfg.grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    sl = step.to_local() if isinstance(step, DTensor) else step
    lr = lr_schedule(cfg, sl)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(_f32(b1, sl), sl.float())
    bc2 = 1.0 - torch.pow(_f32(b2, sl), sl.float())
    eps = _f32(cfg.eps, sl)
    wd = _f32(cfg.weight_decay, sl)

    ms, vs = dict(named_leaves(state.m)), dict(named_leaves(state.v))
    gs = dict(named_leaves(grads))
    for path, p in named_leaves(params):
        decay = _decay_mask(path)
        g, m, v = gs[path], ms[path], vs[path]
        if isinstance(p, DTensor):
            g = g.redistribute(p.device_mesh, p.placements).to_local()
            p, m, v = p.to_local(), m.to_local(), v.to_local()
        for p_s, g_s, m_s, v_s in zip(*(_slabs(t) for t in (p, g, m, v))):
            g = g_s.float() * clip
            m_s.mul_(b1).add_(g * (1 - b1))
            v_s.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            delta = (m_s / bc1) / (torch.sqrt(v_s / bc2) + eps)
            pf = p_s.float()
            if decay:
                delta = delta + wd * pf
            p_s.copy_(pf - lr * delta)
    return params, OptState(m=state.m, v=state.v, step=step), {"grad_norm": gnorm, "lr": lr}
