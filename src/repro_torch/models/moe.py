"""Mixture-of-Experts block: top-k routing and a capacity-bounded grouped
matmul, the reference's ``models/moe.py`` on one device.

Each assignment (token, choice) gets its rank within its expert from a
token-major one-hot cumulative sum; the tokens are scattered into an
[Ep, C, d] buffer, the experts run as one batched matmul, and the results
are gathered back and weighted. An assignment whose rank reaches the
capacity C is dropped (it falls through via the residual); it still adds a
zero contribution into its expert's slot C-1, as the reference's
``.at[ids, rank].add`` does. So the routing is coupled across the batch: a
token's drops depend on the tokens before it.

The expert weights are padded to ``Ep = max(E, expert_pad_to)``; routing
runs over the real E only and the pad experts receive zero rows. The
reference's sharding annotations and its several-device ``moe_mlp_shardmap``
are not carried over. The capacity factor is ``tuning.FLAGS.capacity_factor``
where set, else the config's, as in the reference.

Under autograd the block is differentiable as the reference's is: the
gradients flow through the gate probabilities (the renormalised top-k
weights and the aux loss's mean probabilities) and the expert weights; the
top-k ids, the one-hot counts and the capacity ranks are integers.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import tuning

Params = Dict[str, Any]


class Routing(NamedTuple):
    """One batch's routing. Assignments are flattened token-major, [T*k]."""

    probs: torch.Tensor  # [T, E] f32 softmax of the router logits
    gate_w: torch.Tensor  # [T, k] f32, renormalised over the k choices
    gate_ids: torch.Tensor  # [T, k] int64 experts, by descending probability
    rank: torch.Tensor  # [T*k] int64 rank of each assignment within its expert
    valid: torch.Tensor  # [T*k] bool, rank < capacity (False = dropped)


def padded_experts(cfg) -> int:
    return max(cfg.num_experts, cfg.expert_pad_to or 0)


def _expert_init(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """Normal weights of ``shape`` times ``scale``, drawn in float32 one
    index of the leading axis at a time (a float32 draw of a whole stack of
    experts would take twice its bf16 size again) and cast to ``dtype``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        w = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=device)
        out[i] = (w * scale).to(dtype)
    return out


def init_moe(gen: torch.Generator, cfg, device, lead=()) -> Params:
    """The router (float32), the expert weights padded to ``Ep`` and the
    shared experts, with leading axes ``lead``, and the reference's
    distributions (normal / sqrt(in))."""
    d, ff, E, dt = cfg.d_model, cfg.moe_d_ff, cfg.num_experts, cfg.pdtype
    Ep = padded_experts(cfg)
    p: Params = {
        "router": L.dense_init(gen, (*lead, d, E), torch.float32, device),
        "w_gate": _expert_init(gen, (*lead, Ep, d, ff), 1.0 / math.sqrt(d), dt, device),
        "w_up": _expert_init(gen, (*lead, Ep, d, ff), 1.0 / math.sqrt(d), dt, device),
        "w_down": _expert_init(gen, (*lead, Ep, ff, d), 1.0 / math.sqrt(ff), dt, device),
    }
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * ff
        p["shared"] = {
            "w_gate": L.dense_init(gen, (*lead, d, sf), dt, device),
            "w_up": L.dense_init(gen, (*lead, d, sf), dt, device),
            "w_down": L.dense_init(gen, (*lead, sf, d), dt, device),
        }
    return p


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for a batch of ``tokens``: tokens * k / E times the
    capacity factor, rounded up to a multiple of 8 and at least 8."""
    cf = tuning.FLAGS.capacity_factor or cfg.capacity_factor
    cap = int(math.ceil(tokens * cfg.moe_top_k / cfg.num_experts * cf))
    return max(8, ((cap + 7) // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, descending, ties to the lower index as
    ``lax.top_k`` orders them (a stable descending sort does; ``torch.topk``
    does not promise it)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def gate(router: torch.Tensor, xf: torch.Tensor, k: int):
    """(probs [T, E], gate_w [T, k], gate_ids [T, k]) of tokens xf [T, d]:
    float32 logits, softmax, top k, the k weights renormalised."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gate_w, gate_ids = top_k(probs, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_w, gate_ids


def route(router: torch.Tensor, xf: torch.Tensor, cfg, cap: int) -> Routing:
    """Route tokens xf [T, d]: gates, then each assignment's rank within its
    expert in token-major order, and whether it fits the capacity ``cap``."""
    E, k = cfg.num_experts, cfg.moe_top_k
    probs, gate_w, gate_ids = gate(router, xf, k)
    flat_ids = gate_ids.reshape(-1)
    pos_in_expert = torch.cumsum(F.one_hot(flat_ids, E), dim=0) - 1  # [T*k, E]
    rank = pos_in_expert.gather(1, flat_ids[:, None])[:, 0]
    return Routing(probs=probs, gate_w=gate_w, gate_ids=gate_ids, rank=rank, valid=rank < cap)


def moe_mlp(params: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss f32 scalar)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.moe_top_k
    C = capacity(T, cfg)
    xf = x.reshape(T, d)
    r = route(params["router"], xf, cfg, C)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e, f_e the top-1 share
    ce = F.one_hot(r.gate_ids[:, 0], E).float().mean(0)
    aux = E * torch.sum(r.probs.mean(0) * ce) * cfg.router_aux_weight

    # dispatch: every assignment adds into (expert, min(rank, C-1)); dropped
    # ones add zeros, valid ones own their slot
    flat_ids = r.gate_ids.reshape(-1)
    rank_c = r.rank.clamp(max=C - 1)
    token_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    contrib = xf[token_idx] * r.valid[:, None].to(x.dtype)
    xe = torch.zeros((padded_experts(cfg), C, d), dtype=x.dtype, device=x.device)
    xe.index_put_((flat_ids, rank_c), contrib, accumulate=True)

    # the experts: one batched matmul each for gate, up and down
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])  # [Ep, C, d]

    # combine: gather back, weight, sum over the k choices
    w = (r.gate_w.reshape(T * k, 1) * r.valid[:, None]).to(ye.dtype)
    out = (ye[flat_ids, rank_c] * w).reshape(T, k, d).sum(1)

    if cfg.num_shared_experts:
        sp = params["shared"]
        out = out + (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
    return out.reshape(B, S, d), aux
