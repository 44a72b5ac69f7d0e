"""Decoder-only transformer, the prefill half (dense and MoE families).

Layers are stacked along a leading axis, as in the reference, and run in a
Python loop over that axis (the reference's ``lax.scan``). Inference needs
neither sharding annotations nor remat, so neither is carried over.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import moe

Params = Dict[str, Any]


class PrefillKV(NamedTuple):
    """The prompt's keys and values, [L, B, max_len, nkv, dh] each (zero
    past ``pos``), and ``pos``, the number of prompt tokens."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int


# --------------------------------------------------------------------------- init
def init_params(gen: torch.Generator, cfg, device) -> Params:
    """Random weights with the reference's distributions (normal / sqrt(in)
    dense weights, 0.02-scaled embedding, unit norms), drawn from ``gen`` on
    ``device``; every layer's weights are stacked on a leading L axis. An MoE
    config's layers hold ``moe`` (router, experts, shared experts) in place
    of ``mlp``."""
    d, lead = cfg.d_model, (cfg.num_layers,)
    embed = L.embed_init(gen, cfg.vocab_size, d, cfg.pdtype, device)  # drawn first
    layers: Params = {
        "attn_norm": torch.ones((*lead, d), dtype=cfg.pdtype, device=device),
        "attn": L.init_attention(gen, cfg, device, lead),
        "mlp_norm": torch.ones((*lead, d), dtype=cfg.pdtype, device=device),
    }
    if cfg.is_moe:
        layers["moe"] = moe.init_moe(gen, cfg, device, lead)
    else:
        layers["mlp"] = L.init_mlp(gen, cfg, device, lead)
    p: Params = {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), cfg.pdtype, device)
    return p


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s weights: views into the stacked tensors."""
    def take(tree):
        return {k: take(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[l]

    return take(params["layers"])


# --------------------------------------------------------------------------- block
def block_full(lp: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """One decoder layer over a full sequence. Returns (x, (k, v))."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.causal_attention(q, k, v, sliding_window=cfg.sliding_window)
    x = x + o.reshape(*x.shape[:2], -1) @ lp["attn"]["w_o"]
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + mlp_block(lp, h, cfg), (k, v)


def mlp_block(lp: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """The layer's feed-forward half: the MoE block (its aux loss dropped:
    inference) or the dense MLP."""
    if cfg.is_moe:
        return moe.moe_mlp(lp["moe"], h, cfg)[0]
    return L.mlp(lp["mlp"], h, cfg)


# --------------------------------------------------------------------------- forward
def embed_tokens(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.cdtype)


def forward_hidden(params: Params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
                   collect_kv: bool = False):
    """Run the layer stack. x: [B, S, d]. Returns (hidden, kv | None) with
    kv = (k, v), each [L, B, S, nkv, dh], when ``collect_kv``."""
    ks, vs = [], []
    for l in range(cfg.num_layers):
        x, (k, v) = block_full(layer_params(params, l), x, cfg, positions)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def lm_head_weight(params: Params, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T  # [d, V]
    return params["lm_head"]


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg, max_len: int):
    """Process a full prompt (tokens [B, S]); returns (last-token logits
    [B, 1, V] float32, ``PrefillKV`` padded to ``max_len``)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, cfg)
    h, (k, v) = forward_hidden(params, x, cfg, positions, collect_kv=True)
    pad = max_len - S
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    logits = (h[:, -1:] @ lm_head_weight(params, cfg)).float()
    return logits, PrefillKV(k=k.to(cfg.cdtype), v=v.to(cfg.cdtype), pos=S)
