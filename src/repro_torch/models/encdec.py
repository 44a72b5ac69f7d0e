"""Whisper-style encoder-decoder backbone [arXiv:2212.04356], the reference's
``models/encdec.py`` on PyTorch.

The conv audio frontend is a stub: the encoder takes precomputed frame
embeddings [B, enc_len, d] (what the 2x strided conv1d stem would produce).
Positions are parameter-free sinusoids, computed on the fly. Pre-LN
LayerNorm blocks with biases, GELU MLPs, MHA (kv heads == heads); the output
head is tied to the embedding.

Attention: the training forward (``loss_fn``) runs ``blocked_attention``
(autograd), the prefills the ``flash_attention`` kernel: the encoder and the
cross-attention non-causal (``layers.full_attention``), the decoder's
self-attention causal. The decode writes the self-attention cache in place;
the cross-attention cache is written once, by the prefill.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.manager import resolve_device
from repro_torch.launch.partitioning import gather_fsdp, shard, take_rows
from repro_torch.models import layers as L
from repro_torch.models.transformer import chunked_ce_loss, run_stack, take

Params = Dict[str, Any]


class EncDecCache(NamedTuple):
    """k, v [L, B, S, h, dh]: the decoder's self-attention (written in place
    by ``decode_step``); ck, cv [L, B, enc_len, h, dh]: the cross-attention's
    keys and values (fixed after the prefill); pos: tokens decoded."""

    k: torch.Tensor
    v: torch.Tensor
    ck: torch.Tensor
    cv: torch.Tensor
    pos: int


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions [...] -> [..., d] sinusoidal embedding (float32)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _ln_params(lead, d, dt, device) -> Params:
    return {"w": torch.ones((*lead, d), dtype=dt, device=device),
            "b": torch.zeros((*lead, d), dtype=dt, device=device)}


def _ln(x, p, eps):
    return L.layer_norm(x, p["w"], p["b"], eps)


def init_params(gen: torch.Generator, cfg, device) -> Params:
    d, dt = cfg.d_model, cfg.pdtype
    enc, dec = (cfg.encoder_layers,), (cfg.num_layers,)
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, d, dt, device),
        "enc_layers": {
            "attn_norm": _ln_params(enc, d, dt, device),
            "attn": L.init_attention(gen, cfg, device, enc),
            "mlp_norm": _ln_params(enc, d, dt, device),
            "mlp": L.init_mlp(gen, cfg, device, enc),
        },
        "enc_norm": _ln_params((), d, dt, device),
        "dec_layers": {
            "attn_norm": _ln_params(dec, d, dt, device),
            "attn": L.init_attention(gen, cfg, device, dec),
            "cross_norm": _ln_params(dec, d, dt, device),
            "cross": L.init_attention(gen, cfg, device, dec),
            "mlp_norm": _ln_params(dec, d, dt, device),
            "mlp": L.init_mlp(gen, cfg, device, dec),
        },
        "final_norm": _ln_params((), d, dt, device),
    }


def _attend(q, k, v, *, causal: bool, flash: bool):
    """Prefill attention through the kernel (``flash``), else the blocked
    attention at its default blocks, as the reference's encoder-decoder
    calls it."""
    if flash:
        return L.causal_attention(q, k, v) if causal else L.full_attention(q, k, v)
    return L.blocked_attention(q, k, v, causal=causal)


def _mlp_half(lp, h, cfg):
    return h + L.mlp(lp["mlp"], _ln(h, lp["mlp_norm"], cfg.norm_eps), cfg)


# --------------------------------------------------------------------------- encoder
def _enc_layer(lp: Params, h: torch.Tensor, cfg, flash: bool) -> torch.Tensor:
    B, T, _ = h.shape
    a = _ln(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], a, cfg)
    o = _attend(q, k, v, causal=False, flash=flash)
    h = h + o.reshape(B, T, -1) @ lp["attn"]["w_o"]
    return _mlp_half(lp, h, cfg)


def encode(params: Params, enc_embeds: torch.Tensor, cfg, *, remat: str = "block",
           flash: bool = False) -> torch.Tensor:
    """enc_embeds: [B, T, d], the stub frontend's output. ``flash``: the
    ``flash_attention`` kernel (non-causal) in place of
    ``blocked_attention``."""
    B, T, d = enc_embeds.shape
    pos = torch.arange(T, device=enc_embeds.device)
    x = shard(enc_embeds.to(cfg.cdtype) + sinusoid(pos, d).to(cfg.cdtype), "batch", "enc_seq", None)
    x = run_stack(params["enc_layers"], cfg.encoder_layers, _enc_layer, x, remat, cfg, flash)
    return _ln(x, params["enc_norm"], cfg.norm_eps)


# --------------------------------------------------------------------------- decoder
def _embed_dec(params: Params, tokens: torch.Tensor, cfg, pos0: int = 0) -> torch.Tensor:
    S_ = tokens.shape[1]
    pos = torch.arange(pos0, pos0 + S_, device=tokens.device)
    x = take_rows(params["embed"], tokens.long()).to(cfg.cdtype)
    return shard(x + sinusoid(pos, cfg.d_model).to(cfg.cdtype), "batch", "seq", None)


def _dec_layer_full(lp: Params, x: torch.Tensor, enc_out: torch.Tensor, cfg, flash: bool,
                    kv_out=None) -> torch.Tensor:
    """One decoder layer over a full sequence; ``kv_out``, a list, gets the
    layer's (k, v, cross k, cross v) in the compute dtype."""
    B, Sq, _ = x.shape
    a = _ln(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], a, cfg)
    o = _attend(q, k, v, causal=True, flash=flash)
    x = x + o.reshape(B, Sq, -1) @ lp["attn"]["w_o"]
    c = _ln(x, lp["cross_norm"], cfg.norm_eps)
    qc, _, _ = L.qkv_project(lp["cross"], c, cfg)
    _, kc, vc = L.qkv_project(lp["cross"], enc_out, cfg)
    oc = _attend(qc, kc, vc, causal=False, flash=flash)
    x = x + oc.reshape(B, Sq, -1) @ lp["cross"]["w_o"]
    if kv_out is not None:
        kv_out.append(tuple(t.to(cfg.cdtype) for t in (k, v, kc, vc)))
    return _mlp_half(lp, x, cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg, *, remat: str = "block"):
    """batch: enc_embeds [B, T, d], tokens [B, S], labels [B, S] (-1
    ignored). Returns (loss, {"ce", "aux", "tokens"})."""
    tokens, labels = batch["tokens"], batch["labels"]
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=remat)
    x = _embed_dec(params, tokens, cfg)
    x = run_stack(params["dec_layers"], cfg.num_layers, _dec_layer_full, x, remat, enc_out,
                  cfg, False)
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    tot, cnt = chunked_ce_loss(x, gather_fsdp(params["embed"]).T, labels, cfg)  # head tied to the embedding
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32, device=x.device),
                  "tokens": cnt}


# --------------------------------------------------------------------------- decode
def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> EncDecCache:
    """A zero cache on ``device`` (``None`` = the card, which raises where
    there is none)."""
    device = resolve_device(device, what="the decode cache")
    dt = dtype or cfg.cdtype
    Ld, h, dh, T = cfg.num_layers, cfg.num_kv_heads, cfg.d_head, cfg.max_encoder_len

    def zeros(n):
        return torch.zeros((Ld, batch, n, h, dh), dtype=dt, device=device)

    return EncDecCache(k=zeros(max_len), v=zeros(max_len), ck=zeros(T), cv=zeros(T), pos=0)


def _cross_kv(params: Params, enc_out: torch.Tensor, cfg):
    """Every decoder layer's cross-attention keys and values of ``enc_out``,
    [L, B, T, h, dh] each, in the compute dtype."""
    ks, vs = [], []
    for l in range(cfg.num_layers):
        _, k, v = L.qkv_project(take(params["dec_layers"], l)["cross"],
                                enc_out, cfg)
        ks.append(k.to(cfg.cdtype))
        vs.append(v.to(cfg.cdtype))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def prefill_cross(params: Params, enc_embeds: torch.Tensor, cfg, max_len: int) -> EncDecCache:
    """Encode and precompute every layer's cross-attention K/V; the
    self-attention cache is empty."""
    enc_out = encode(params, enc_embeds, cfg, remat="none", flash=True)
    ck, cv = _cross_kv(params, enc_out, cfg)
    base = init_cache(cfg, enc_out.shape[0], max_len, device=enc_out.device)
    return base._replace(ck=ck, cv=cv)


@torch.no_grad()
def prefill(params: Params, enc_embeds: torch.Tensor, tokens: torch.Tensor, cfg, max_len: int):
    """Encoder + teacher-forced decoder prefill. Returns (last-token logits
    [B, V] float32, the full ``EncDecCache``)."""
    enc_out = encode(params, enc_embeds, cfg, remat="none", flash=True)
    B, Sq = tokens.shape
    x = _embed_dec(params, tokens, cfg)
    kv = []
    for l in range(cfg.num_layers):
        x = _dec_layer_full(take(params["dec_layers"], l), x, enc_out, cfg,
                            True, kv)
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    logits = shard((x[:, -1] @ gather_fsdp(params["embed"]).T).float(), "batch", "vocab")
    k, v, ck, cv = (torch.stack(t) for t in zip(*kv))
    pad = max_len - Sq
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return logits, EncDecCache(k=k, v=v, ck=ck, cv=cv, pos=Sq)


@torch.no_grad()
def decode_step(params: Params, token: torch.Tensor, cache: EncDecCache, cfg):
    """One decode step. token: [B] int. Returns (logits [B, V] float32, the
    cache with ``pos`` + 1); the self-attention k and v are written in place
    at ``pos``."""
    B, pos = token.shape[0], cache.pos
    if pos >= cache.k.shape[2]:
        raise ValueError(f"the cache holds {cache.k.shape[2]} positions; it is full")
    x = _embed_dec(params, token[:, None], cfg, pos)
    T = cache.ck.shape[2]
    for l in range(cfg.num_layers):
        lp = take(params["dec_layers"], l)
        a = _ln(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], a, cfg)
        cache.k[l, :, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[l, :, pos] = v[:, 0].to(cache.v.dtype)
        o = L.decode_attention(q, cache.k[l], cache.v[l], pos + 1)
        x = x + o.reshape(B, 1, -1) @ lp["attn"]["w_o"]
        c = _ln(x, lp["cross_norm"], cfg.norm_eps)
        qc, _, _ = L.qkv_project(lp["cross"], c, cfg)
        oc = L.decode_attention(qc, cache.ck[l], cache.cv[l], T)
        x = x + oc.reshape(B, 1, -1) @ lp["cross"]["w_o"]
        x = _mlp_half(lp, x, cfg)
    x = _ln(x, params["final_norm"], cfg.norm_eps)
    logits = shard((x[:, 0] @ gather_fsdp(params["embed"]).T).float(), "batch", "vocab")
    return logits, cache._replace(pos=pos + 1)
