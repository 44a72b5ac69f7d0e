"""TrainState and the train / eval step factories, the reference's
``training/train_state.py`` on PyTorch.

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``. The gradients come from autograd over the port's ``loss_fn``;
the parameters and the AdamW moments are then updated in place (the
reference's jit donates the state), and the returned state holds them.
``microbatch`` > 1 splits the batch into K slices of consecutive rows (the
first microbatch is the first rows, as the reference's reshape gives) and
accumulates their gradients in float32 before one optimizer step.

``state_from_numpy`` carries the reference's ``TrainState`` across (its
leaves as numpy arrays, ``jax.device_get``), which is how the tests run both
packages from one state.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.manager import resolve_device
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import get_model
from repro_torch.training import grad_compression as gc
from repro_torch.training.optimizer import (
    AdamWConfig,
    OptState,
    adamw_update,
    init_opt_state,
    named_leaves,
    tree_map,
)

METRIC_KEYS = ("ce", "aux", "tokens", "loss")


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    error_buf: Optional[Any] = None  # grad-compression error feedback


def init_train_state(cfg, seed: int = 0, *, compress_grads: bool = False,
                     device=None) -> TrainState:
    """Random weights from ``seed`` and zero moments on ``device`` (``None``
    = the card, which raises where there is none)."""
    dev = resolve_device(device, what="the trainer")
    params = get_model(cfg).init(seed=seed, device=dev)
    return TrainState(
        params=params,
        opt=init_opt_state(params),
        error_buf=gc.init_error_buf(params) if compress_grads else None,
    )


def state_from_numpy(cfg, state_np, device) -> TrainState:
    """The port's ``TrainState`` from the reference's, numpy leaves: the
    params in the config's dtypes, m, v and the error buffer in float32."""
    f32 = torch.float32
    err = state_np.error_buf
    return TrainState(
        params=params_from_numpy(cfg, state_np.params, device),
        opt=OptState(
            m=params_from_numpy(cfg, state_np.opt.m, device, dtype=f32),
            v=params_from_numpy(cfg, state_np.opt.v, device, dtype=f32),
            step=torch.tensor(int(np.asarray(state_np.opt.step)), dtype=torch.int32,
                              device=device),
        ),
        error_buf=None if err is None else params_from_numpy(cfg, err, device, dtype=f32),
    )


def state_to(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device``, tensor by tensor."""
    def move(tree):
        return None if tree is None else tree_map(lambda t: t.to(device, copy=True), tree)

    return TrainState(params=move(state.params),
                      opt=OptState(m=move(state.opt.m), v=move(state.opt.v),
                                   step=state.opt.step.to(device, copy=True)),
                      error_buf=move(state.error_buf))


def make_train_step(cfg, opt_cfg: AdamWConfig, *, remat: str = "block",
                    compress_grads: bool = False, microbatch: int = 1):
    """Build train_step(state, batch) -> (state, metrics); batch holds
    ``tokens`` and ``labels`` [B, S] on the state's device. The metrics are
    float32 scalars on the device: ce, aux, tokens, loss, grad_norm, lr."""
    api = get_model(cfg)

    def _grads(params, batch):
        leaf = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = api.loss(leaf, batch, remat=remat)
            flat = [p for _, p in named_leaves(leaf)]
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
        got = {id(p): (torch.zeros_like(p) if g is None else g) for p, g in zip(flat, gs)}
        grads = tree_map(lambda p: got[id(p)], leaf)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return grads, metrics

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatch > 1:
            B = batch["tokens"].shape[0]
            if B % microbatch:
                raise ValueError(f"batch {B} does not split into {microbatch} microbatches")
            n = B // microbatch
            grads, msum = None, None
            for i in range(microbatch):
                g, metrics = _grads(state.params, {k: v[i * n : (i + 1) * n]
                                                   for k, v in batch.items()})
                if grads is None:
                    grads = tree_map(lambda t: t.float(), g)
                    msum = {k: metrics[k] for k in METRIC_KEYS}
                else:
                    tree_map(lambda a, b: a.add_(b.float()), grads, g)
                    msum = {k: msum[k] + metrics[k] for k in METRIC_KEYS}
                del g
            k_f32 = torch.full((), float(microbatch), dtype=torch.float32,
                               device=batch["tokens"].device)
            tree_map(lambda t: t.div_(k_f32), grads)
            metrics = {k: v / k_f32 for k, v in msum.items()}
            metrics["tokens"] = metrics["tokens"] * microbatch
        else:
            grads, metrics = _grads(state.params, batch)
        error_buf = state.error_buf
        if compress_grads and error_buf is not None:
            grads, error_buf = gc.compress_decompress(grads, error_buf)
        params, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        metrics.update(opt_metrics)
        return TrainState(params=params, opt=opt, error_buf=error_buf), metrics

    return train_step


def make_eval_step(cfg, *, remat: str = "none"):
    api = get_model(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = api.loss(params, batch, remat=remat)
        return metrics

    return eval_step
