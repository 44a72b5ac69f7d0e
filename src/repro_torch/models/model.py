"""Unified model API of the port — dispatch on ``cfg.family``.

    api = get_model(cfg)
    params = api.init(seed)                 # on "cuda" unless device= says otherwise
    loss, metrics = api.loss(params, batch)
    cache = api.init_cache(batch_size, max_len)
    logits, cache = api.decode(params, token, cache)
    logits, cache = api.prefill(params, tokens, max_len)

The dense, MoE and VLM families (one decoder-only transformer) are ported;
the others raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.manager import resolve_device
from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode: Callable[..., Any]
    prefill: Callable[..., Any]


def _init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights from ``seed`` on ``device`` (``None`` = the card,
    which raises where there is none)."""
    dev = resolve_device(device, what="the model")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return transformer.init_params(gen, cfg, dev)


def _init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    dev = resolve_device(device, what="the KV cache")
    return transformer.init_kv_cache(cfg, batch, max_len, dtype, dev)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device=None: _init(cfg, seed, device),
            loss=lambda p, b, **kw: transformer.loss_fn(p, b, cfg, **kw),
            init_cache=lambda bs, ml, **kw: _init_cache(cfg, bs, ml, **kw),
            decode=lambda p, t, c: transformer.decode_step(p, t, c, cfg),
            prefill=lambda p, t, ml: transformer.prefill(p, t, cfg, ml),
        )
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: it waits for ROADMAP Queue 1 item 10"
    )
