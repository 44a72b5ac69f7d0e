"""Shared model building blocks on PyTorch (functional, param dicts).

Conventions, as in the reference's ``models/layers.py``:
  - params are nested dicts of tensors; a dense weight is [in, out]
  - activations flow as [batch, seq, d_model] in ``cfg.cdtype``
  - norms and softmax statistics accumulate in float32; ``tuning.FLAGS``
    (``norm_bf16_apply``, ``attn_score_f32``) change that as in the
    reference

Prefill attention runs through ``ops.flash_attention``: the CUDA kernel for
tensors on the card, its plain version for tensors on the CPU. The
training forward runs ``blocked_attention`` (plain torch under autograd:
the kernel has no backward, in either package), the contiguous-cache
decode ``decode_attention`` / ``decode_attention_stats``.

Where the reference asks for ``preferred_element_type=float32`` on bf16
operands, the port casts the operands to float32 and multiplies in float32:
``torch.matmul`` on bf16 rounds its output to bf16, which would not match.
On the card that product runs on the CUDA cores (a peak of 67 TFLOP/s, not
the 989 of bf16 on the tensor cores; TF32 is left off), so the blocked
attention of a training step runs at the float32 rate.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.launch.partitioning import attention_on_shards
from repro_torch.models import tuning

Params = Dict[str, Any]


# --------------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape, dtype, device, scale: Optional[float] = None):
    """Normal weights of ``shape`` (..., in, out) scaled by 1/sqrt(in),
    drawn in float32 from ``gen`` and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device):
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


def init_mlp(gen, cfg, device, lead=()) -> Params:
    """MLP weights with leading axes ``lead`` (the stacked layer axis)."""
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    p: Params = {}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, (*lead, d, ff), dt, device)
    p["w_up"] = dense_init(gen, (*lead, d, ff), dt, device)
    p["w_down"] = dense_init(gen, (*lead, ff, d), dt, device)
    return p


def init_attention(gen, cfg, device, lead=()) -> Params:
    d, dh, nh, nkv, dt = cfg.d_model, cfg.d_head, cfg.num_heads, cfg.num_kv_heads, cfg.pdtype
    p: Params = {
        "w_q": dense_init(gen, (*lead, d, nh * dh), dt, device),
        "w_k": dense_init(gen, (*lead, d, nkv * dh), dt, device),
        "w_v": dense_init(gen, (*lead, d, nkv * dh), dt, device),
        "w_o": dense_init(gen, (*lead, nh * dh, d), dt, device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((*lead, nh * dh), dtype=dt, device=device)
        p["b_k"] = torch.zeros((*lead, nkv * dh), dtype=dt, device=device)
        p["b_v"] = torch.zeros((*lead, nkv * dh), dtype=dt, device=device)
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((*lead, dh), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*lead, dh), dtype=dt, device=device)
    return p


# --------------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if tuning.FLAGS.norm_bf16_apply and dt != torch.float32:
        # float32 only for the reduction; the [B, S, 1] scale applies in the
        # compute dtype
        scale = torch.rsqrt(var + eps).to(dt)
        return (x * scale) * weight
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------- rope
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    base = torch.full((), theta, dtype=torch.float32, device=device)  # a fill, no copy
    return 1.0 / torch.pow(base, exps)


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float):
    """The rotation of ``positions`` [..., seq]: (cos, sin), each
    [..., seq, 1, d_head/2] float32. A caller that rotates several tensors
    at the same positions computes it once."""
    freqs = rope_freqs(d_head, theta, positions.device)
    angles = positions[..., :, None].float() * freqs  # [..., seq, d/2]
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, d_head] rotated by ``rope_cos_sin``'s output."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] (int)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


# --------------------------------------------------------------------------- mlp
def mlp(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    act = cfg.activation
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif act == "geglu":
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * (x @ params["w_up"])
    elif act == "squared_relu":
        h = torch.square(F.relu(x @ params["w_up"]))
    elif act == "gelu":
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act}")
    return h @ params["w_down"]


# --------------------------------------------------------------------------- attention
def qkv_project(params: Params, x: torch.Tensor, cfg):
    """x: [B, S, d] -> q [B, S, nh, dh], k/v [B, S, nkv, dh]."""
    B, S, _ = x.shape
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    q = q.reshape(B, S, cfg.num_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.d_head)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def causal_attention(q, k, v, *, sliding_window: int = 0) -> torch.Tensor:
    """Causal GQA attention over a full sequence, the prefill's
    (``blocked_attention`` in the reference). q: [B, S, nh, dh]; k, v:
    [B, S, nkv, dh]. Returns [B, S, nh, dh]. The kernel takes heads before
    positions, so q, k and v are transposed into that layout."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    o = ops.flash_attention(qh, kh, vh, causal=True, sliding_window=sliding_window)
    return o.transpose(1, 2)


def full_attention(q, k, v) -> torch.Tensor:
    """Non-causal attention of every query over every key, the prefill's
    (the encoder-decoder's encoder and cross-attention; ``blocked_attention
    (causal=False)`` in the reference). q: [B, Sq, nh, dh]; k, v: [B, Skv,
    nkv, dh], Sq and Skv free. Returns [B, Sq, nh, dh]."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return ops.flash_attention(qh, kh, vh, causal=False).transpose(1, 2)


def blocked_attention(q, k, v, *, causal: bool, q_block: int = 512, kv_block: int = 1024,
                      sliding_window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Memory-efficient attention in plain torch, differentiable by autograd:
    an online softmax over kv blocks, as the reference's ``lax.scan``.

    q: [B, Sq, nh, dh]; k, v: [B, Skv, nkv, dh] with nh % nkv == 0. Returns
    [B, Sq, nh, dh]. Scores and probabilities are float32, or bf16 when
    ``tuning.FLAGS.attn_score_f32`` is off. The keys are padded to a multiple
    of ``kv_block`` and the pad is masked.

    The reference runs every kv block for every query row. For a row that a
    block masks entirely, that step leaves the running output, maximum and
    sum exactly as they were (a correction of exp(0) = 1 and zero
    probabilities), and for a block that masks nothing the masking selects
    every score. So the port runs its queries in blocks of ``kv_block`` rows
    (aligned with the kv blocks on the causal diagonal), skips the kv blocks
    that mask a whole query block, and masks only the blocks that mask some
    of it: the arithmetic of every row is the reference's, with less work
    and fewer launches (smaller query blocks would skip as much and launch
    twice as often). No row reads another, so the reference's query pad
    (``q_block``) is not needed, and ``q_block`` changes nothing here. A
    query group of ``nh //
    nkv`` heads is folded into the rows of one product with its KV head,
    where the reference repeats the keys: the same products. A row that
    every key masks gets a zero output.

    Under a device mesh (``DTensor`` inputs) it runs on each rank's lanes and
    heads (``partitioning.attention_on_shards``)."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        def call(q, k, v):
            return blocked_attention(q, k, v, causal=causal, q_block=q_block, kv_block=kv_block,
                                     sliding_window=sliding_window, q_offset=q_offset)

        return attention_on_shards(call, q, (k, v), (), q_heads=2, kv_heads=2, kv_batch=0)
    B, Sq, nh, dh = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nh // nkv
    dev = q.device
    sdt = torch.float32 if tuning.FLAGS.attn_score_f32 else torch.bfloat16
    # device scalars made by fills: a tensor from a Python number would be a
    # host-to-device copy, which waits for the card
    scale = torch.full((), 1.0 / math.sqrt(dh), dtype=sdt, device=dev)
    kv_block = min(kv_block, Skv)
    pk = (-Skv) % kv_block
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nk = (Skv + pk) // kv_block
    kh = k.permute(0, 2, 1, 3)  # [B, nkv, Skv_p, dh]
    vh = v.permute(0, 2, 1, 3)
    # head h = n * g + j reads KV head n, as jnp.repeat lays the heads out
    qh = q.permute(0, 2, 1, 3).reshape(B, nkv, g, Sq, dh).float()

    outs = []
    for q_lo in range(0, Sq, kv_block):
        n = min(kv_block, Sq - q_lo)
        qg = qh[:, :, :, q_lo : q_lo + n].reshape(B, nkv, g * n, dh)
        first, last = q_offset + q_lo, q_offset + q_lo + n - 1  # the block's positions
        q_pos = torch.arange(first, last + 1, device=dev)
        j_hi = min(nk, last // kv_block + 1) if causal else nk
        j_lo = max(0, (first - sliding_window + 1) // kv_block) if sliding_window else 0
        acc = torch.zeros((B, nkv, g, n, dh), dtype=sdt, device=dev)
        m = torch.full((B, nkv, g, n), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, nkv, g, n), dtype=torch.float32, device=dev)
        for j in range(j_lo, j_hi):
            lo, hi = j * kv_block, (j + 1) * kv_block
            k_j, v_j = kh[:, :, lo:hi], vh[:, :, lo:hi]
            s = (qg @ k_j.float().transpose(-1, -2)).view(B, nkv, g, n, kv_block)
            s = s.to(sdt) * scale
            masks_some = (hi > Skv or (causal and hi - 1 > first)
                          or (sliding_window and lo <= last - sliding_window))
            if masks_some:
                kv_pos = torch.arange(lo, hi, device=dev)
                mask = (kv_pos < Skv)[None, :].expand(n, kv_block)
                if causal:
                    mask = mask & (kv_pos[None, :] <= q_pos[:, None])
                if sliding_window:
                    mask = mask & (kv_pos[None, :] > q_pos[:, None] - sliding_window)
                s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1).float())
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)  # fully masked rows
            p = torch.exp(s - m_safe[..., None].to(sdt))
            if masks_some:
                p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1).float()
            pv = p.to(v_j.dtype).reshape(B, nkv, g * n, kv_block).float() @ v_j.float()
            acc = acc * corr[..., None].to(sdt) + pv.view(B, nkv, g, n, dh).to(sdt)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-37))
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    return out.reshape(B, nh, Sq, dh).permute(0, 2, 1, 3).to(q.dtype)


def _decode_scores(q, k_cache, length, sliding_window: int):
    """Scores [B, nkv, g, 1, S] (float32) of one query token against the
    cache, and the mask [B or 1, 1, 1, 1, S] of the first ``length`` keys
    (the last ``sliding_window`` of them when set)."""
    B, S, nkv, dh = k_cache.shape
    g = q.shape[2] // nkv
    qg = q.reshape(B, nkv, g, dh).float()
    s = (qg @ k_cache.float().permute(0, 2, 3, 1))[:, :, :, None, :]  # [B, nkv, g, 1, S]
    s = s * (1.0 / math.sqrt(dh))
    pos = torch.arange(S, device=q.device)[None, :]
    if not isinstance(length, int):  # one length per lane
        length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = pos < length
    if sliding_window:
        mask = mask & (pos >= length - sliding_window)
    return s, mask[:, None, None, None, :]


def _decode_values(p, v_cache):
    """[B, nkv, g, 1, dh] float32: p [B, nkv, g, 1, S] cast to the cache's
    dtype, times the values in float32."""
    return p.to(v_cache.dtype).float() @ v_cache.float().permute(0, 2, 1, 3)[:, :, None]


def decode_attention_stats(q, k_cache, v_cache, length, *, sliding_window: int = 0):
    """``decode_attention`` returning (acc, m, l), the unnormalised output
    [B, nkv, g, 1, dh] and the online-softmax statistics [B, nkv, g, 1], so a
    caller can merge more keys exactly (the deferred cache commit); acc / l
    is the normalised output. Every key masked gives m = -inf, l = 0."""
    s, mask = _decode_scores(q, k_cache, length, sliding_window)
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    return _decode_values(p, v_cache), m, p.sum(dim=-1)


def decode_attention(q, k_cache, v_cache, length, *, sliding_window: int = 0) -> torch.Tensor:
    """Single-token decode attention over a contiguous cache.

    q: [B, 1, nh, dh]; k_cache, v_cache: [B, S, nkv, dh]; length: the
    context length (an int, or a tensor of one per lane). Returns
    [B, 1, nh, dh]. ``DTensor`` inputs run on each rank's lanes and heads
    (``partitioning.attention_on_shards``)."""
    if isinstance(q, DTensor):
        lanes = () if isinstance(length, int) else (length,)

        def call(q, k, v, *n):
            return decode_attention(q, k, v, n[0] if n else length,
                                    sliding_window=sliding_window)

        return attention_on_shards(call, q, (k_cache, v_cache), lanes, q_heads=2, kv_heads=2,
                                   kv_batch=0)
    B, nh, dh = q.shape[0], q.shape[2], q.shape[3]
    s, mask = _decode_scores(q, k_cache, length, sliding_window)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    out = _decode_values(p, v_cache)  # [B, nkv, g, 1, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, nh, dh).to(q.dtype)
