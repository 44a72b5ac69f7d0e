"""Pure Mamba2 LM (mamba2-130m): embed -> N SSD layers -> norm -> logits, the
reference's ``models/ssm_lm.py`` on PyTorch.

Layers are stacked on a leading axis and run in a Python loop over it (the
reference's ``lax.scan``); per-layer remat is ``torch.utils.checkpoint``
around each layer. ``decode_step`` writes the cache's conv windows and states
in place; ``prefill`` builds a new cache.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.core.manager import resolve_device
from repro_torch.launch.partitioning import shard
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (
    chunked_ce_loss,
    embed_tokens,
    layer_params,
    lm_head_weight,
    run_stack,
)

Params = Dict[str, Any]


class SSMLMCache(NamedTuple):
    """Every layer's ``SSMCache``, stacked: conv [L, B, W-1, C], state [L,
    B, H, P, N]; ``pos`` the tokens consumed (the reference's [] int32, a
    Python int here)."""

    layers: S.SSMCache
    pos: int


def init_params(gen: torch.Generator, cfg, device) -> Params:
    d, lead = cfg.d_model, (cfg.num_layers,)
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, d, cfg.pdtype, device),
        "layers": {
            "norm": torch.ones((*lead, d), dtype=cfg.pdtype, device=device),
            "ssm": S.init_ssm(gen, cfg, device, lead),
        },
        "final_norm": torch.ones((d,), dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), cfg.pdtype, device)
    return p


def mamba_layer(lp: Params, x: torch.Tensor, cfg, with_cache: bool = False):
    """Pre-norm residual Mamba2 layer. Returns (x, cache | None)."""
    out, cache = S.ssm_forward(lp["ssm"], L.rms_norm(x, lp["norm"], cfg.norm_eps), cfg,
                               with_cache=with_cache)
    return x + out, cache


def _layer(lp: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return mamba_layer(lp, x, cfg)[0]


def run_layers(layers: Params, n: int, x: torch.Tensor, cfg, remat: str) -> torch.Tensor:
    """x through ``n`` stacked Mamba2 layers (``transformer.run_stack``)."""
    return run_stack(layers, n, _layer, x, remat, cfg)


def forward_hidden(params: Params, x: torch.Tensor, cfg, *, remat: str = "block"):
    """Returns (hidden, aux = 0, None), the transformer's signature."""
    x = run_layers(params["layers"], cfg.num_layers, x, cfg, remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), None


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg, *, remat: str = "block"):
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux, _ = forward_hidden(params, embed_tokens(params, tokens, cfg), cfg, remat=remat)
    tot, cnt = chunked_ce_loss(h, lm_head_weight(params, cfg), labels, cfg)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"ce": loss, "aux": aux, "tokens": cnt}


def stack_caches(caches) -> S.SSMCache:
    return S.SSMCache(conv=torch.stack([c.conv for c in caches]),
                      state=torch.stack([c.state for c in caches]))


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg, max_len: int = 0):
    """Full-prompt forward from a zero state. Returns (last-token logits [B,
    V] float32, ``SSMLMCache`` after the prompt); ``max_len`` is unused (the
    state does not grow)."""
    B, S_ = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    caches = []
    for l in range(cfg.num_layers):
        x, c = mamba_layer(layer_params(params, l), x, cfg, with_cache=True)
        caches.append(c)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard((x[:, -1] @ lm_head_weight(params, cfg)).float(), "batch", "vocab")
    return logits, SSMLMCache(layers=stack_caches(caches), pos=S_)


def init_cache(cfg, batch: int, max_len: int = 0, dtype=None, device=None) -> SSMLMCache:
    """Zero state for ``batch`` lanes on ``device`` (``None`` = the card,
    which raises where there is none; ``max_len`` and ``dtype`` are unused:
    the state's dtypes are the config's, as in the reference)."""
    device = resolve_device(device, what="the decode cache")
    return SSMLMCache(layers=S.init_ssm_cache(cfg, batch, (cfg.num_layers,), device), pos=0)


def decode_layer(lp: Params, x: torch.Tensor, cache: S.SSMCache, cfg) -> torch.Tensor:
    """One token through a pre-norm Mamba2 layer; writes ``cache`` in place."""
    return x + S.ssm_decode_step(lp["ssm"], L.rms_norm(x, lp["norm"], cfg.norm_eps), cache, cfg)


@torch.no_grad()
def decode_step(params: Params, token: torch.Tensor, cache: SSMLMCache, cfg):
    """One decode step. token: [B] int. Returns (logits [B, V] float32, the
    cache with ``pos`` + 1); every layer's conv window and state are written
    in place."""
    x = embed_tokens(params, token[:, None], cfg)
    for l in range(cfg.num_layers):
        x = decode_layer(layer_params(params, l), x,
                         S.SSMCache(cache.layers.conv[l], cache.layers.state[l]), cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard((x[:, 0] @ lm_head_weight(params, cfg)).float(), "batch", "vocab")
    return logits, SSMLMCache(layers=cache.layers, pos=cache.pos + 1)
