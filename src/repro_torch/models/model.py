"""Unified model API of the port — dispatch on ``cfg.family``.

    api = get_model(cfg)
    params = api.init(seed)                 # on "cuda" unless device= says otherwise
    loss, metrics = api.loss(params, batch)
    cache = api.init_cache(batch_size, max_len)
    logits, cache = api.decode(params, token, cache)
    logits, cache = api.prefill(params, tokens, max_len)

Every family of the reference: the decoder-only transformer (dense, MoE,
VLM), the Mamba2 SSM, the hybrid and the encoder-decoder. The audio
family's ``prefill`` is ``encdec.prefill_cross(params, enc_embeds,
max_len)``, as in the reference; its teacher-forced prefill is
``encdec.prefill``. Unlike the reference's, the SSM and hybrid APIs expose
their ``prefill`` (the reference's modules have it).

``input_specs(cfg, shape)`` gives a ``(shape, dtype)`` record for each
model input of a shape cell (the reference's ShapeDtypeStruct stand-ins for
the dry-run); nothing is allocated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.manager import resolve_device
from repro_torch.models import encdec, hybrid, ssm_lm, transformer


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode: Callable[..., Any]
    prefill: Callable[..., Any]


# family -> (module, its cache builder)
_FAMILIES = {
    "dense": (transformer, transformer.init_kv_cache),
    "moe": (transformer, transformer.init_kv_cache),
    "vlm": (transformer, transformer.init_kv_cache),
    "ssm": (ssm_lm, ssm_lm.init_cache),
    "hybrid": (hybrid, hybrid.init_cache),
    "audio": (encdec, encdec.init_cache),
}


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    mod, make_cache = _FAMILIES[cfg.family]

    def init(seed: int = 0, device=None):
        """Random weights from ``seed`` on ``device`` (``None`` = the card,
        which raises where there is none)."""
        dev = resolve_device(device, what="the model")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return mod.init_params(gen, cfg, dev)

    def init_cache(batch: int, max_len: int = 0, dtype=None, device=None):
        dev = resolve_device(device, what="the decode cache")
        return make_cache(cfg, batch, max_len, dtype, dev)

    if cfg.family == "audio":
        prefill = lambda p, e, ml: encdec.prefill_cross(p, e, cfg, ml)  # noqa: E731
    else:
        prefill = lambda p, t, ml=0: mod.prefill(p, t, cfg, ml)  # noqa: E731
    return ModelAPI(
        cfg=cfg,
        init=init,
        loss=lambda p, b, **kw: mod.loss_fn(p, b, cfg, **kw),
        init_cache=init_cache,
        decode=lambda p, t, c: mod.decode_step(p, t, c, cfg),
        prefill=prefill,
    )


# --------------------------------------------------------------------------- specs
class InputSpec(NamedTuple):
    """The shape and dtype of one model input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, InputSpec]:
    """Stand-ins for every model input of a shape cell: train and prefill
    cells feed the loss (tokens and labels; the encoder-decoder's frame
    embeddings too), decode cells the decode step (one token per lane)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.is_decode:
        return {"token": InputSpec((B,), torch.int32)}
    specs = {"tokens": InputSpec((B, S), torch.int32), "labels": InputSpec((B, S), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["enc_embeds"] = InputSpec((B, cfg.max_encoder_len, cfg.d_model), cfg.cdtype)
    return specs
