"""Decoder-only transformer (dense, MoE and VLM backbones): training
forward and loss, prefill, and the contiguous-cache decode.

Layers are stacked along a leading axis, as in the reference, and run in a
Python loop over that axis (the reference's ``lax.scan``). Per-layer remat
is ``torch.utils.checkpoint`` around each layer. The reference's logical
sharding annotations (``launch.partitioning.shard``) stand at the same
sites; they are the identity on plain tensors and outside a mesh context.

Attention: the training forward (``loss_fn``) runs ``L.blocked_attention``,
which autograd differentiates, as the reference's ``_attn_full`` does; the
prefill runs the ``flash_attention`` kernel (``L.causal_attention``), which
has no backward. The decode reads and writes a ``KVCache`` in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.core.manager import resolve_device
from repro_torch.launch.partitioning import attention_on_shards, gather_fsdp, shard, take_rows
from repro_torch.models import layers as L
from repro_torch.models import moe, tuning

Params = Dict[str, Any]

# remat -> what each layer keeps for the backward. Eager torch has no
# "save the dot products" policy, so "dots" recomputes the whole layer as
# "block" does (the reference's default, which the parity tests run).
REMAT_POLICIES = ("none", "block", "dots")


class KVCache(NamedTuple):
    """Contiguous decode cache: k, v [L, B, S_max, nkv, dh] each (zero past
    ``pos``), and ``pos``, the number of tokens in it (the reference's []
    int32, a Python int here). ``decode_step`` writes k and v in place."""

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


def take(tree, i: int):
    """Entry ``i`` of every leaf's leading axis: views into stacked tensors
    (under a mesh, with their data-axis sharding gathered)."""
    return {k: take(v, i) for k, v in tree.items()} if isinstance(tree, dict) else gather_fsdp(
        tree[i])


def layer_params(params: Params, l: int) -> Params:
    """Layer ``l``'s weights: views into the stacked tensors."""
    return take(params["layers"], l)


# --------------------------------------------------------------------------- block
def block_full(lp: Params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
               flash: bool = False):
    """One decoder layer over a full sequence. Returns (x, aux, (k, v)).
    ``flash``: the prefill's ``flash_attention`` kernel in place of
    ``blocked_attention``."""
    x = shard(x, "batch", "seq", None)  # a sequence-parallel residual gathered
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    if flash:
        o = L.causal_attention(q, k, v, sliding_window=cfg.sliding_window)
    else:
        o = L.blocked_attention(q, k, v, causal=True, sliding_window=cfg.sliding_window,
                                q_block=tuning.FLAGS.q_block, kv_block=tuning.FLAGS.kv_block)
    # the heads' partial sums reduced here, so the MLP's input is whole on
    # "model" (its products then split d_ff, as the weights do)
    x = shard(x + o.reshape(*x.shape[:2], -1) @ lp["attn"]["w_o"], "batch", "seq", None)
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.is_moe:
        m, aux = moe.moe_mlp(lp["moe"], h, cfg)
    else:
        m, aux = L.mlp(lp["mlp"], h, cfg), torch.zeros((), dtype=torch.float32, device=x.device)
    # sequence parallelism (Megatron): the residual stream is sharded over
    # "model" between the layers of a model without MoE
    seq = "seq_sp" if tuning.FLAGS.seq_parallel_activations and not cfg.is_moe else "seq"
    return shard(x + m, "batch", seq, None), aux, (k, v)


def mlp_block(lp: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """The feed-forward half of a decode step's layer: the MoE block (its
    aux loss dropped, as the reference's decode drops it) or the dense
    MLP."""
    if cfg.is_moe:
        return moe.moe_mlp(lp["moe"], h, cfg)[0]
    return L.mlp(lp["mlp"], h, cfg)


# --------------------------------------------------------------------------- forward
def embed_tokens(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = take_rows(params["embed"], tokens.long())
    return shard(x.to(cfg.cdtype), "batch", "seq", None)


def forward_hidden(params: Params, x: torch.Tensor, cfg, positions: torch.Tensor, *,
                   remat: str = "block", collect_kv: bool = False, flash: bool = False):
    """Run the layer stack. x: [B, S, d]. Returns (hidden, aux, kv | None):
    aux the sum of the layers' MoE losses (float32), kv = (k, v), each
    [L, B, S, nkv, dh], when ``collect_kv``. Under autograd and a ``remat``
    other than "none", each layer keeps only its input for the backward and
    is run again there."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_POLICIES}")
    use_ckpt = remat != "none" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        if use_ckpt:
            x, a, (k, v) = checkpoint(block_full, lp, x, cfg, positions, flash=flash,
                                      use_reentrant=False)
        else:
            x, a, (k, v) = block_full(lp, x, cfg, positions, flash=flash)
        aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def run_stack(layers: Params, n: int, body, x: torch.Tensor, remat: str, *args) -> torch.Tensor:
    """x through ``n`` layers stacked on the leading axis of ``layers``, each
    ``body(layer_params, x, *args) -> x``. Under autograd and a ``remat``
    other than "none", each layer keeps only its input for the backward and
    is run again there."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_POLICIES}")
    use_ckpt = remat != "none" and torch.is_grad_enabled()
    for l in range(n):
        lp = take(layers, l)
        x = checkpoint(body, lp, x, *args, use_reentrant=False) if use_ckpt else body(lp, x, *args)
    return x


def lm_head_weight(params: Params, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return gather_fsdp(params["embed"]).T  # [d, V]
    return gather_fsdp(params["lm_head"])


def ce_chunk_size(B: int, S: int, V: int) -> int:
    """The reference's chunk rule: about 64 MB of float32 logits a chunk,
    a power of two, at least 16, at most S."""
    chunk = max(16, min(S, int(64e6 / max(B * V * 4, 1)) or 16))
    chunk = max(16, 1 << (chunk.bit_length() - 1))
    return min(chunk, S)


def _ce_chunk(h: torch.Tensor, lab: torch.Tensor, head: torch.Tensor):
    """(sum of -log p(label), valid labels) of one chunk, float32."""
    ldt = torch.bfloat16 if tuning.FLAGS.loss_logits_bf16 else torch.float32
    logits = shard((h @ head).to(ldt), "batch", None, "vocab")  # [B, chunk, V]
    lse = torch.logsumexp(logits.float(), dim=-1, keepdim=True)
    lab_c = lab.clamp(0, head.shape[1] - 1).long()[..., None]
    ll = logits.gather(-1, lab_c).float()  # [B, chunk, 1]
    valid = (lab >= 0).float()[..., None]
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, cfg,
                    chunk: int = 0):
    """Cross-entropy over sequence chunks, summed in order as the reference's
    scan: peak memory is [B, chunk, V] logits instead of [B, S, V]. Labels of
    -1 are ignored. Returns (sum_loss, n_valid). Under autograd each chunk is
    run again in the backward (``torch.utils.checkpoint``), so one chunk's
    float32 logits are alive at a time, not every chunk's; the loss is the
    same."""
    B, S, _ = hidden.shape
    if chunk <= 0:
        chunk = ce_chunk_size(B, S, head.shape[1])
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S + pad, chunk):
        h, lab = hidden[:, lo : lo + chunk], labels[:, lo : lo + chunk]
        if grad:
            t, n = checkpoint(_ce_chunk, h, lab, head, use_reentrant=False)
        else:
            t, n = _ce_chunk(h, lab, head)
        tot = tot + t
        cnt = cnt + n
    return tot, cnt


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg, *, remat: str = "block"):
    """Next-token LM loss. batch: tokens [B, S], labels [B, S] (-1 ignore).
    Returns (loss + aux, {"ce", "aux", "tokens"}), float32 scalars."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, cfg)
    h, aux, _ = forward_hidden(params, x, cfg, positions, remat=remat)
    tot, cnt = chunked_ce_loss(h, lm_head_weight(params, cfg), labels, cfg)
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux, {"ce": loss, "aux": aux, "tokens": cnt}


# --------------------------------------------------------------------------- decode
def init_kv_cache(cfg, batch: int, max_len: int, dtype=None, device=None) -> KVCache:
    """A zero cache on ``device`` (``None`` = the card, which raises where
    there is none)."""
    device = resolve_device(device, what="the decode cache")
    dt = dtype or cfg.cdtype
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device), pos=0)


def shard_kv_cache(cache: KVCache) -> KVCache:
    return KVCache(k=shard(cache.k, None, "batch", "kv_seq", "kv_heads", None),
                   v=shard(cache.v, None, "batch", "kv_seq", "kv_heads", None), pos=cache.pos)


@torch.no_grad()
def prefill(params: Params, tokens: torch.Tensor, cfg, max_len: int):
    """Process a full prompt (tokens [B, S]); returns (last-token logits
    [B, 1, V] float32, ``KVCache`` of ``max_len`` positions holding the
    prompt)."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    x = embed_tokens(params, tokens, cfg)
    h, _, (k, v) = forward_hidden(params, x, cfg, positions, remat="none", collect_kv=True,
                                  flash=True)
    pad = max_len - S
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    logits = (h[:, -1:] @ lm_head_weight(params, cfg)).float()
    return logits, shard_kv_cache(KVCache(k=k.to(cfg.cdtype), v=v.to(cfg.cdtype), pos=S))


def _decode_rope(x: torch.Tensor, cfg, pos: int):
    """The rotation (cos, sin) of position ``pos`` for a step's B lanes,
    computed once a step: every layer rotates at the same position."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


def _decode_qkv(lp: Params, x: torch.Tensor, cfg, pos: int, rope=None):
    """The new token's q, k, v, rotated to position ``pos``."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], h, cfg)
    cos, sin = rope if rope is not None else _decode_rope(x, cfg, pos)
    return L.rotate(q, cos, sin), L.rotate(k, cos, sin), v


def _decode_out(lp: Params, x: torch.Tensor, o: torch.Tensor, cfg) -> torch.Tensor:
    """The layer's rest after attention: output projection, residual, MLP."""
    x = x + o.reshape(x.shape[0], 1, -1) @ lp["attn"]["w_o"]
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + mlp_block(lp, h, cfg)


def block_decode(lp: Params, x: torch.Tensor, cfg, k_cache, v_cache, pos: int, rope=None):
    """One decoder layer for a single new token. x: [B, 1, d]; k_cache,
    v_cache: [B, S, nkv, dh], the new key and value written at ``pos`` in
    place, then attention over the first pos + 1; ``rope``: the step's
    ``_decode_rope``. Returns (x, k_cache, v_cache)."""
    q, k, v = _decode_qkv(lp, x, cfg, pos, rope)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    o = L.decode_attention(q, k_cache, v_cache, pos + 1, sliding_window=cfg.sliding_window)
    return _decode_out(lp, x, o, cfg), k_cache, v_cache


def _block_decode_deferred(lp: Params, x: torch.Tensor, cfg, k_cache, v_cache, pos: int,
                           rope=None):
    """``block_decode`` that leaves the cache alone: attention runs over the
    ``pos`` tokens in it and the current token's key and value are merged
    into the softmax exactly. Returns (x, k, v), the new k, v [B, 1, nkv,
    dh] for one commit after the stack."""
    q, k, v = _decode_qkv(lp, x, cfg, pos, rope)
    o = _attend_deferred(q, k_cache, v_cache, k, v, pos, cfg.sliding_window, x.dtype)
    return _decode_out(lp, x, o, cfg), k, v


def _attend_deferred(q, k_cache, v_cache, k, v, pos: int, sliding_window: int, dtype):
    """The deferred commit's attention of q [B, 1, nh, dh] over the ``pos``
    cached keys and the current token's k, v [B, 1, nkv, dh], merged
    exactly; [B, 1, nh, dh] in ``dtype``. ``DTensor`` inputs run on each
    rank's lanes and heads."""
    if isinstance(q, DTensor):
        def call(q, k_cache, v_cache, k, v):
            return _attend_deferred(q, k_cache, v_cache, k, v, pos, sliding_window, dtype)

        return attention_on_shards(call, q, (k_cache, v_cache, k, v), (), q_heads=2,
                                   kv_heads=2, kv_batch=0)
    B, _, nh, dh = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    acc, m, l = L.decode_attention_stats(q, k_cache, v_cache, pos, sliding_window=sliding_window)
    # the current token: score q.k_new, value v_new
    qg = q.reshape(B, 1, nkv, g, dh).float()
    s_new = (qg * k.float().reshape(B, 1, nkv, 1, dh)).sum(-1).permute(0, 2, 3, 1)
    s_new = s_new / torch.sqrt(torch.full((), dh, dtype=torch.float32, device=q.device))
    m2 = torch.maximum(m, s_new)  # [B, nkv, g, 1]
    w_c = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m2))
    w_n = torch.exp(s_new - m2)
    v_n = v.float().reshape(B, 1, nkv, 1, dh).permute(0, 2, 3, 1, 4)  # [B, nkv, 1, 1, dh]
    acc2 = acc * w_c[..., None] + w_n[..., None] * v_n
    l2 = l * w_c + w_n
    o = (acc2 / torch.clamp(l2[..., None], min=1e-30)).to(dtype)
    return o.permute(0, 3, 1, 2, 4).reshape(B, 1, nh, dh)  # heads h = n * g + j


@torch.no_grad()
def decode_step(params: Params, token: torch.Tensor, cache: KVCache, cfg):
    """One decode step. token: [B] int. Returns (logits [B, V] float32, the
    cache with ``pos`` + 1). The cache's k and v are written in place (the
    reference updates a donated buffer). Under
    ``tuning.FLAGS.decode_deferred_commit`` every layer reads the cache as
    it was and the new keys and values of all layers are written once
    after the stack; otherwise each layer writes its own first."""
    pos = cache.pos
    if pos >= cache.k.shape[2]:
        raise ValueError(f"the cache holds {cache.k.shape[2]} positions; it is full")
    x = embed_tokens(params, token[:, None], cfg)
    rope = _decode_rope(x, cfg, pos)
    if tuning.FLAGS.decode_deferred_commit:
        k_tok, v_tok = [], []
        for l in range(cfg.num_layers):
            x, k_new, v_new = _block_decode_deferred(layer_params(params, l), x, cfg,
                                                     cache.k[l], cache.v[l], pos, rope)
            k_tok.append(k_new[:, 0])
            v_tok.append(v_new[:, 0])
        # one commit for every layer: [L, B, nkv, dh] at position pos
        cache.k[:, :, pos] = torch.stack(k_tok).to(cache.k.dtype)
        cache.v[:, :, pos] = torch.stack(v_tok).to(cache.v.dtype)
    else:
        for l in range(cfg.num_layers):
            x, _, _ = block_decode(layer_params(params, l), x, cfg, cache.k[l], cache.v[l], pos,
                                   rope)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = shard((h[:, 0] @ lm_head_weight(params, cfg)).float(), "batch", "vocab")
    return logits, shard_kv_cache(KVCache(k=cache.k, v=cache.v, pos=pos + 1))
