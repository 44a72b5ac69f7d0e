"""Shared model building blocks on PyTorch (functional, param dicts).

Conventions, as in the reference's ``models/layers.py``:
  - params are nested dicts of tensors; a dense weight is [in, out]
  - activations flow as [batch, seq, d_model] in ``cfg.cdtype``
  - norms apply in float32 and attention scores are float32 (the
    reference's default tuning; its tuning knobs are not carried over)

Prefill attention runs through ``ops.flash_attention``: the CUDA kernel for
tensors on the card, its plain version for tensors on the CPU.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


# --------------------------------------------------------------------------- rope
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


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
