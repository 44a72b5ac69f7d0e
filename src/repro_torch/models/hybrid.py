"""Zamba2-style hybrid: a Mamba2 trunk plus one shared (weight-tied)
attention + MLP block invoked after every ``cfg.attn_every`` SSM layers
[arXiv:2411.15242], the reference's ``models/hybrid.py`` on PyTorch.

As in the reference, the shared block takes the hidden state directly (no
concatenation with the embedding, no per-invocation LoRA deltas) and attends
over a sliding window (``cfg.sliding_window``), so long-context decode stays
sub-quadratic. Layer layout for L = 38, attn_every = 6: 6 groups of (6 Mamba2
layers -> the shared block) + 2 tail Mamba2 layers. Each invocation has its
own KV cache (shared weights, separate state).

The training forward runs ``blocked_attention`` (autograd); the prefill runs
the ``flash_attention`` kernel (``block_full(flash=True)``). The decode keeps
each invocation's keys in a ring of ``window`` slots (position p at slot p %
window) and writes the ring, the SSM conv windows and the states in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.manager import resolve_device
from repro_torch.launch.partitioning import gather_fsdp, shard
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.ssm_lm import decode_layer, mamba_layer, run_layers, stack_caches
from repro_torch.models.transformer import (
    block_full,
    chunked_ce_loss,
    embed_tokens,
    lm_head_weight,
    run_stack,
    take,
)

Params = Dict[str, Any]


class HybridCache(NamedTuple):
    """group_ssm: leaves [G, per_group, B, ...]; tail_ssm: [max(tail, 1), B,
    ...]; k, v: [G, B, window, nkv, dh] rings; pos: tokens consumed."""

    group_ssm: S.SSMCache
    tail_ssm: S.SSMCache
    k: torch.Tensor
    v: torch.Tensor
    pos: int


def _layout(cfg) -> Tuple[int, int, int]:
    groups = cfg.attn_invocations
    per_group = cfg.attn_every
    tail = cfg.num_layers - groups * per_group
    return groups, per_group, tail


def _mamba_layers(gen, cfg, device, lead) -> Params:
    return {"norm": torch.ones((*lead, cfg.d_model), dtype=cfg.pdtype, device=device),
            "ssm": S.init_ssm(gen, cfg, device, lead)}


def init_params(gen: torch.Generator, cfg, device) -> Params:
    """``mamba_groups`` leaves [G, per_group, ...], ``mamba_tail`` [tail, ...]
    (absent without a tail), one ``shared_attn`` block with
    ``transformer.block_full``'s keys."""
    groups, per_group, tail = _layout(cfg)
    d, dt = cfg.d_model, cfg.pdtype
    p: Params = {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dt, device),
        "mamba_groups": _mamba_layers(gen, cfg, device, (groups, per_group)),
        "shared_attn": {
            "attn_norm": torch.ones((d,), dtype=dt, device=device),
            "attn": L.init_attention(gen, cfg, device),
            "mlp_norm": torch.ones((d,), dtype=dt, device=device),
            "mlp": L.init_mlp(gen, cfg, device),
        },
        "final_norm": torch.ones((d,), dtype=dt, device=device),
    }
    if tail:
        p["mamba_tail"] = _mamba_layers(gen, cfg, device, (tail,))
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, (d, cfg.vocab_size), dt, device)
    return p


def _positions(B: int, S_: int, device) -> torch.Tensor:
    return torch.arange(S_, dtype=torch.int32, device=device).expand(B, S_)


# --------------------------------------------------------------------------- train
def _group_body(gp: Params, x, shared: Params, cfg, positions, remat: str):
    x = run_layers(gp, cfg.attn_every, x, cfg, remat)
    return block_full(shared, x, cfg, positions)[0]


def forward_hidden(params: Params, x: torch.Tensor, cfg, positions, *, remat: str = "block"):
    """Returns (hidden, aux = 0, None). Under autograd and a ``remat`` other
    than "none", each Mamba2 layer and each group (its layers and the shared
    block) keep only their input for the backward, as the reference's nested
    ``jax.checkpoint``."""
    groups, per_group, tail = _layout(cfg)
    x = run_stack(params["mamba_groups"], groups, _group_body, x, remat,
                  gather_fsdp(params["shared_attn"]), cfg, positions, remat)
    if tail:
        x = run_layers(params["mamba_tail"], tail, x, cfg, remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), None


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg, *, remat: str = "block"):
    tokens, labels = batch["tokens"], batch["labels"]
    B, S_ = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    h, aux, _ = forward_hidden(params, x, cfg, _positions(B, S_, tokens.device), remat=remat)
    tot, cnt = chunked_ce_loss(h, lm_head_weight(params, cfg), labels, cfg)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux, {"ce": loss, "aux": aux, "tokens": cnt}


def _window(cfg, max_len: int) -> int:
    """The ring's slots: min(max_len, sliding_window), or max_len without a
    window. ``prefill`` and ``init_cache`` must agree on it, or the slot map
    diverges after the handoff to ``decode_step``."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg, max_len: int = 0):
    """Full-prompt forward: builds the SSM states and each invocation's
    ring-buffer KV (key position p at slot p % window, as ``decode_step``
    writes them). Returns (last-token logits [B, V] float32,
    ``HybridCache``)."""
    B, S_ = tokens.shape
    dev = tokens.device
    positions = _positions(B, S_, dev)
    x = embed_tokens(params, tokens, cfg)
    groups, per_group, tail = _layout(cfg)
    shared = gather_fsdp(params["shared_attn"])
    # the ring keeps each invocation's last `window` keys and values
    window = _window(cfg, max(max_len, S_))
    lo = S_ - min(S_, window)

    group_caches, ks, vs = [], [], []
    for g in range(groups):
        gp, layer_caches = take(params["mamba_groups"], g), []
        for l in range(per_group):
            x, c = mamba_layer(take(gp, l), x, cfg, with_cache=True)
            layer_caches.append(c)
        group_caches.append(stack_caches(layer_caches))
        x, _, (k, v) = block_full(shared, x, cfg, positions, flash=True)
        ks.append(k[:, lo:])
        vs.append(v[:, lo:])
    tail_ssm = S.init_ssm_cache(cfg, B, (max(tail, 1),), dev)
    if tail:
        tail_caches = []
        for l in range(tail):
            x, c = mamba_layer(take(params["mamba_tail"], l), x, cfg,
                               with_cache=True)
            tail_caches.append(c)
        tail_ssm = stack_caches(tail_caches)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard((x[:, -1] @ lm_head_weight(params, cfg)).float(), "batch", "vocab")

    # pack them in ring order: position lo + i at slot (lo + i) % window
    # (lo > 0 only when the last `window` positions fill the ring)
    def ring(t):
        t = torch.stack(t).to(cfg.cdtype)  # [G, B, S_ - lo, nkv, dh]
        return torch.roll(F.pad(t, (0, 0, 0, 0, 0, window - t.shape[2])), lo % window, 2)

    if groups:
        kc, vc = ring(ks), ring(vs)
    else:
        shape = (groups, B, window, cfg.num_kv_heads, cfg.d_head)
        kc = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
        vc = torch.zeros(shape, dtype=cfg.cdtype, device=dev)
    return logits, HybridCache(group_ssm=stack_caches(group_caches), tail_ssm=tail_ssm,
                               k=kc, v=vc, pos=S_)


# --------------------------------------------------------------------------- decode
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> HybridCache:
    """A zero cache on ``device`` (``None`` = the card, which raises where
    there is none)."""
    device = resolve_device(device, what="the decode cache")
    groups, per_group, tail = _layout(cfg)
    dt = dtype or cfg.cdtype
    kv_shape = (groups, batch, _window(cfg, max_len), cfg.num_kv_heads, cfg.d_head)
    return HybridCache(
        group_ssm=S.init_ssm_cache(cfg, batch, (groups, per_group), device),
        tail_ssm=S.init_ssm_cache(cfg, batch, (max(tail, 1),), device),
        k=torch.zeros(kv_shape, dtype=dt, device=device),
        v=torch.zeros(kv_shape, dtype=dt, device=device),
        pos=0,
    )


def _shared_decode(shared: Params, x, cfg, k_ring, v_ring, pos: int):
    """The shared block for one token at absolute position ``pos``: RoPE at
    ``pos``, the key and value written at slot pos % window in place, then
    attention over the min(pos + 1, window) written slots."""
    B, window = x.shape[0], k_ring.shape[1]
    hn = L.rms_norm(x, shared["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(shared["attn"], hn, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    slot = pos % window
    k_ring[:, slot] = k[:, 0].to(k_ring.dtype)
    v_ring[:, slot] = v[:, 0].to(v_ring.dtype)
    o = L.decode_attention(q, k_ring, v_ring, min(pos + 1, window))
    x = x + o.reshape(B, 1, -1) @ shared["attn"]["w_o"]
    hn = L.rms_norm(x, shared["mlp_norm"], cfg.norm_eps)
    return x + L.mlp(shared["mlp"], hn, cfg)


@torch.no_grad()
def decode_step(params: Params, token: torch.Tensor, cache: HybridCache, cfg):
    """One decode step. token: [B] int. Returns (logits [B, V] float32, the
    cache with ``pos`` + 1); the rings, conv windows and states are written
    in place."""
    groups, per_group, tail = _layout(cfg)
    x = embed_tokens(params, token[:, None], cfg)
    pos = cache.pos
    shared = gather_fsdp(params["shared_attn"])
    gs = cache.group_ssm
    for g in range(groups):
        gp = take(params["mamba_groups"], g)
        for l in range(per_group):
            x = decode_layer(take(gp, l), x,
                             S.SSMCache(gs.conv[g, l], gs.state[g, l]), cfg)
        x = _shared_decode(shared, x, cfg, cache.k[g], cache.v[g], pos)
    for l in range(tail):
        x = decode_layer(take(params["mamba_tail"], l), x,
                         S.SSMCache(cache.tail_ssm.conv[l], cache.tail_ssm.state[l]), cfg)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard((x[:, 0] @ lm_head_weight(params, cfg)).float(), "batch", "vocab")
    return logits, cache._replace(pos=pos + 1)
