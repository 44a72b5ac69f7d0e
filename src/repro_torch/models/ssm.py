"""Mamba2 / SSD (state-space duality) layer [arXiv:2405.21060] on PyTorch,
the reference's ``models/ssm.py``.

The chunked SSD algorithm for training and prefill (a quadratic,
attention-like form within each chunk and a linear recurrence across chunks,
a Python loop over the chunks where the reference runs ``lax.scan``), and the
O(1)-state recurrent form for decode. Plain torch, reductions in float32: the
SSD scan has no Pallas kernel in the reference, and none here.

Where the reference asks for ``preferred_element_type=float32`` on bf16
operands, the port casts the operands to float32 and multiplies in float32
(``torch.matmul`` on bf16 rounds its output to bf16), as ``layers.py`` does.

The within-chunk decay matrix masks its exponent before ``exp``
(``_decay_matrix``). The reference computes ``exp(ac_i - ac_j)`` for every
pair of a chunk and then keeps the pairs on and below the diagonal; above it
the exponent is a sum of positive terms, which overflows at the published
chunk lengths (128, 256). The forward pass discards the overflow, but the
backward multiplies the discarded entries' zero cotangent by their infinite
derivative, so every gradient becomes NaN. Masking the exponent to -inf
first gives exp(-inf) = 0 exactly, so the forward pass is the same bit for
bit and the gradient is finite.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.manager import resolve_device
from repro_torch.models import tuning
from repro_torch.models.layers import dense_init, rms_norm

Params = Dict[str, Any]

# the within-chunk term materialises [B, chunks, H, Q, Q] float32 tensors;
# the scan takes its chunks in groups of at most this many such elements
# (each chunk's arithmetic is its own and the state is carried across, so
# the grouping changes no bit on the CPU)
GROUP_ELEMS = 1 << 28


class SSMCache(NamedTuple):
    """One layer's decode state (or a stack of them, leading axes first):
    ``conv`` [..., B, W-1, conv_dim] the most recent raw conv inputs in the
    compute dtype, ``state`` [..., B, H, P, N] float32."""

    conv: torch.Tensor
    state: torch.Tensor


def _dims(cfg):
    d = cfg.d_model
    di = cfg.ssm_d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = cfg.ssm_n_groups
    conv_dim = di + 2 * G * N
    return d, di, H, P, N, G, conv_dim


def init_ssm(gen: torch.Generator, cfg, device, lead=()) -> Params:
    """One Mamba2 layer's weights with leading axes ``lead``, the reference's
    distributions: softplus(dt_bias) log-uniform in [1e-3, 1e-1], A = -exp(
    A_log) with exp(A_log) uniform in [1, 16], D = 1. ``A_log``, ``D`` and
    ``dt_bias`` are float32 whatever the param dtype, as in the reference."""
    d, di, H, P, N, G, conv_dim = _dims(cfg)
    if G != 1:
        raise NotImplementedError("ssm_n_groups > 1 is not implemented (nor in the reference)")
    dt, f32 = cfg.pdtype, torch.float32
    d_in_proj = 2 * di + 2 * G * N + H
    u = torch.rand((*lead, H), generator=gen, dtype=f32, device=device)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    W = cfg.ssm_conv_width
    conv_w = torch.randn((*lead, W, conv_dim), generator=gen, dtype=f32, device=device)
    a = torch.rand((*lead, H), generator=gen, dtype=f32, device=device) * 15.0 + 1.0
    return {
        "in_proj": dense_init(gen, (*lead, d, d_in_proj), dt, device),
        "conv_w": (conv_w / math.sqrt(W)).to(dt),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dt, device=device),
        "A_log": torch.log(a),
        "D": torch.ones((*lead, H), dtype=f32, device=device),
        "dt_bias": dt_bias,
        "norm_w": torch.ones((*lead, di), dtype=dt, device=device),
        "out_proj": dense_init(gen, (*lead, di, d), dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d as shift-and-multiply, in x's dtype. x: [B, L,
    C], w: [W, C], b: [C]. W is tiny (4): the shifts keep the filter's
    gradient depthwise."""
    W, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = b
    for i in range(W):
        out = out + xp[:, i : i + L, :] * w[i]
    return out


def _decay_matrix(ac: torch.Tensor) -> torch.Tensor:
    """exp(ac_i - ac_j) for j <= i, else 0: [..., H, Q(i), Q(j)] float32 from
    the cumulative log-decays ac [..., Q, H]. The exponent is masked before
    ``exp`` (see the module's docstring)."""
    a = ac.transpose(-1, -2)  # [..., H, Q]
    seg = a[..., :, None] - a[..., None, :]
    Q = ac.shape[-2]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=ac.device).tril()
    return torch.exp(seg.masked_fill(~tri, -torch.inf))


def _chunk_group(ac, xc, Bc, Cc, h, dtype):
    """SSD over a run of consecutive chunks, entering with state h [B, H, P,
    N]: returns (y [B, c, Q, H, P] in ``dtype``, the state leaving the last
    chunk). ac [B, c, Q, H] float32, xc [B, c, Q, H, P], Bc and Cc [B, c, Q,
    N]."""
    Bsz, nc, Q, H = ac.shape
    P = xc.shape[-1]

    # 1) within-chunk (diagonal) term: (C_i . B_j) exp(ac_i - ac_j) for j <=
    # i, cast to the input dtype where the reference casts W, times x_j
    Lmat = _decay_matrix(ac)  # [B, c, H, Q, Q]
    CB = Cc.float() @ Bc.float().transpose(-1, -2)  # [B, c, Q, Q]
    Wm = (CB[:, :, None] * Lmat).to(dtype)
    y_diag = (Wm.float() @ xc.permute(0, 1, 3, 2, 4).float()).permute(0, 1, 3, 2, 4)

    # 2) end-of-chunk states from within-chunk inputs: [B, c, H, P, N]
    decay_states = torch.exp(ac[:, :, -1:, :] - ac)  # [B, c, Q, H]
    xd = (xc.float() * decay_states[..., None]).permute(0, 1, 3, 4, 2)  # [B, c, H, P, Q]
    states = xd @ Bc.float()[:, :, None]

    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(ac[:, :, -1, :])  # [B, c, H]
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(entering, dim=1)  # [B, c, H, P, N]

    # 4) the entering state's contribution to the outputs
    state_decay = torch.exp(ac)  # [B, c, Q, H]
    hp = h_prev.reshape(Bsz, nc, H * P, -1).transpose(-1, -2)  # [B, c, N, H*P]
    y_off = (Cc.float() @ hp).reshape(Bsz, nc, Q, H, P) * state_decay[..., None]
    return (y_diag + y_off).to(dtype), h


def ssd_scan(
    xh: torch.Tensor,  # [B, L, H, P] (pre-dt)
    dt: torch.Tensor,  # [B, L, H] (post-softplus), float32
    A_log: torch.Tensor,  # [H]
    Bm: torch.Tensor,  # [B, L, N]
    Cm: torch.Tensor,  # [B, L, N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y [B, L, H, P] in xh's dtype, final_state [B,
    H, P, N] float32). The chunks run in groups of consecutive chunks (each
    group's [B, c, H, Q, Q] float32 tensors at most GROUP_ELEMS elements),
    the state carried from one group to the next."""
    Bsz, L, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // Q

    A = -torch.exp(A_log.float())  # [H], negative
    dA = dt.float() * A  # [B, Lp, H] log-decay increments (<= 0)
    xdt = (xh * dt[..., None]).to(xh.dtype)  # the discretised input

    ac = torch.cumsum(dA.reshape(Bsz, nc, Q, H), dim=2)  # [B, c, Q, H] float32
    xc = xdt.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    if initial_state is not None:
        h = initial_state.float()
    else:
        h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
    step = max(1, GROUP_ELEMS // (Bsz * H * Q * Q))
    ys = []
    for lo in range(0, nc, step):
        g = slice(lo, min(nc, lo + step))
        y, h = _chunk_group(ac[:, g], xc[:, g], Bc[:, g], Cc[:, g], h, xh.dtype)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.reshape(Bsz, nc * Q, H, P)[:, :L], h


def ssd_chunk(cfg) -> int:
    """The SSD chunk length: ``tuning.FLAGS.ssd_chunk`` where set, else the
    config's."""
    return tuning.FLAGS.ssd_chunk or cfg.ssm_chunk


def ssm_forward(params: Params, x: torch.Tensor, cfg, *, with_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence Mamba2 layer (train / prefill) from a zero state. x:
    [B, L, d]. Returns (out [B, L, d], the layer's ``SSMCache`` after the
    sequence when ``with_cache``, else None)."""
    d, di, H, P, N, G, conv_dim = _dims(cfg)
    B, L, _ = x.shape
    zxbcdt = x @ params["in_proj"]  # [B, L, 2di + 2N + H]
    z = zxbcdt[..., :di]
    raw = zxbcdt[..., di : di + conv_dim]
    dt = zxbcdt[..., di + conv_dim :]
    xBC = F.silu(_causal_conv(raw, params["conv_w"], params["conv_b"]))
    xs = xBC[..., :di].reshape(B, L, H, P)
    Bm = xBC[..., di : di + N]
    Cm = xBC[..., di + N :]
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B, L, H]

    y, final_state = ssd_scan(xs, dt, params["A_log"], Bm, Cm, ssd_chunk(cfg))
    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(B, L, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    out = y @ params["out_proj"]

    if not with_cache:
        return out, None
    # conv state: the last W-1 raw (pre-conv) inputs, zero-padded on the left;
    # a copy, so the cache does not keep the whole projection alive
    Wd = cfg.ssm_conv_width
    tail = raw[:, -(Wd - 1):, :].clone()
    if tail.shape[1] < Wd - 1:
        tail = F.pad(tail, (0, 0, Wd - 1 - tail.shape[1], 0))
    return out, SSMCache(conv=tail, state=final_state)


def init_ssm_cache(cfg, batch: int, lead=(), device=None) -> SSMCache:
    """Zero decode state for ``batch`` lanes, with leading axes ``lead``, on
    ``device`` (``None`` = the card, which raises where there is none)."""
    device = resolve_device(device, what="the decode cache")
    d, di, H, P, N, G, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((*lead, batch, cfg.ssm_conv_width - 1, conv_dim), dtype=cfg.cdtype,
                         device=device),
        state=torch.zeros((*lead, batch, H, P, N), dtype=torch.float32, device=device),
    )


def ssm_decode_step(params: Params, x: torch.Tensor, cache: SSMCache, cfg) -> torch.Tensor:
    """One-token recurrent step. x: [B, 1, d]. Writes the layer's ``cache``
    (conv window and state) in place; returns out [B, 1, d]."""
    d, di, H, P, N, G, conv_dim = _dims(cfg)
    B = x.shape[0]
    zxbcdt = (x @ params["in_proj"])[:, 0]  # [B, ...]
    z = zxbcdt[:, :di]
    xBC_new = zxbcdt[:, di : di + conv_dim]
    dt = zxbcdt[:, di + conv_dim :]

    # causal conv over (state ++ new)
    win = torch.cat([cache.conv, xBC_new[:, None, :].to(cache.conv.dtype)], dim=1)  # [B, W, C]
    # the reference's einsum: products summed in float32, one rounding
    conv_out = (win.float() * params["conv_w"].float()).sum(dim=1).to(win.dtype) + params["conv_b"]
    xBC = F.silu(conv_out)
    xs = xBC[:, :di].reshape(B, H, P).float()
    Bm = xBC[:, di : di + N].float()
    Cm = xBC[:, di + N :].float()
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B, H]

    A = -torch.exp(params["A_log"].float())
    g = torch.exp(dt * A)  # [B, H]
    delta = dt[:, :, None, None] * xs[:, :, :, None] * Bm[:, None, None, :]  # [B, H, P, N]
    h = cache.state * g[:, :, None, None] + delta
    y = (h @ Cm[:, None, :, None])[..., 0]  # [B, H, P]
    y = y + params["D"].float()[None, :, None] * xs
    y = y.reshape(B, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    cache.conv.copy_(win[:, 1:])
    cache.state.copy_(h)
    return (y @ params["out_proj"])[:, None, :]
