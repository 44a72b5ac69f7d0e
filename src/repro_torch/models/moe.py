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
capacity factor is ``tuning.FLAGS.capacity_factor`` where set, else the
config's, as in the reference.

Under a device mesh (``launch.partitioning.use_partitioning``) and
``tuning.FLAGS.moe_shardmap``, ``moe_mlp`` runs ``moe_mlp_shardmap``, the
reference's token-motion-free expert parallelism: each rank routes its own
tokens into a buffer for its own experts only, runs them, and one
all-reduce over "model" sums the partial outputs.

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

from repro_torch.launch import partitioning as part
from repro_torch.launch.mesh import axis_size
from repro_torch.launch.partitioning import PartitionSpec as P, shard
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
    if tuning.FLAGS.moe_shardmap:
        ctx = part.current()
        if ctx is not None:
            return moe_mlp_shardmap(params, x, cfg, *ctx)
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
    xe = xe.index_put((flat_ids, rank_c), contrib, accumulate=True)
    if tuning.FLAGS.moe_explicit_a2a:
        # the scatter stays token-local (C over data), then one explicit
        # resharding to the expert-parallel layout: the dispatch all-to-all
        xe = shard(shard(xe, None, "a2a_cap", None), "experts", None, None)
    else:
        xe = shard(xe, "experts_buf", "expert_cap", None)

    # the experts: one batched matmul each for gate, up and down
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])  # [Ep, C, d]
    if tuning.FLAGS.moe_explicit_a2a:
        ye = shard(shard(ye, "experts", None, None), None, "a2a_cap", None)  # combine back
    else:
        ye = shard(ye, "experts_buf", "expert_cap", None)

    # combine: gather back, weight, sum over the k choices
    w = (r.gate_w.reshape(T * k, 1) * r.valid[:, None]).to(ye.dtype)
    out = (ye[flat_ids, rank_c] * w).reshape(T, k, d).sum(1)

    if cfg.num_shared_experts:
        sp = params["shared"]
        out = out + (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
    return out.reshape(B, S, d), aux


def moe_mlp_shardmap(params: Params, x: torch.Tensor, cfg, mesh, rules
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_mlp`` with token-motion-free expert parallelism on ``mesh``, the
    reference's ``moe_mlp_shardmap``. The activations are replicated over
    "model", so each rank already holds every token of its data shard and
    the experts of its "model" slice: it routes its tokens over all E
    experts (ranks and capacity counted locally, ``C_dev`` slots per expert
    for its T_local tokens), keeps the assignments to its own experts, runs
    them, and one all-reduce over "model" sums the partial outputs. Token
    dropping is per (rank, expert) instead of global. The shared experts
    are split over "model" by their hidden width where it divides, else run
    whole on model rank 0; either way their output rides the same
    all-reduce (the reference adds unsplit shared experts after it). The aux
    loss is averaged over the data axes.

    Each input is taken as this rank's block of the reference's shard_map
    specs (``partitioning.local_view``: a ``DTensor`` redistributed, a plain
    tensor read as replicated); the results are ``DTensor``s laid out as x
    (out) and replicated (aux) when x is one, else plain tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    Ep = padded_experts(cfg)
    dp_axes = rules.get("batch") or ()
    dp_axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
    m_size = axis_size(mesh, "model")
    ep_sharded = Ep % m_size == 0
    E_local = Ep // m_size if ep_sharded else Ep
    dp_size = math.prod(axis_size(mesh, a) for a in dp_axes)
    T_local = (B // dp_size if B % dp_size == 0 else B) * S
    cf = tuning.FLAGS.capacity_factor or cfg.capacity_factor
    C_dev = max(8, int(math.ceil(T_local * k / E * cf / 8.0)) * 8)

    bspec = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    x_spec = P(bspec, None, None)
    w_spec = P("model" if ep_sharded else None, None, None)
    sf = cfg.num_shared_experts * cfg.moe_d_ff
    shared_ff_sharded = bool(ep_sharded and cfg.num_shared_experts and sf % m_size == 0)
    sg_spec = P(None, "model") if shared_ff_sharded else P(None, None)
    sd_spec = P("model", None) if shared_ff_sharded else P(None, None)

    def local(t, spec):
        return part.local_view(t, mesh, part.to_placements(spec, mesh))

    xl = local(x, x_spec)
    router = local(params["router"], P(None, None))
    wg, wu, wd = (local(params[n], w_spec) for n in ("w_gate", "w_up", "w_down"))
    Bl, Sl, _ = xl.shape
    Tl = Bl * Sl
    xf = xl.reshape(Tl, d)

    # routing over ALL experts, ranks counted locally (no communication)
    r = route(router, xf, cfg, C_dev)
    ce = F.one_hot(r.gate_ids[:, 0], E).float().mean(0)
    aux_l = E * torch.sum(r.probs.mean(0) * ce) * cfg.router_aux_weight

    # keep only the assignments to THIS rank's expert slice
    e_lo = mesh.get_local_rank("model") * E_local if ep_sharded else 0
    flat_ids = r.gate_ids.reshape(-1)
    local_e = flat_ids - e_lo
    mine = (local_e >= 0) & (local_e < wg.shape[0]) & r.valid
    le = local_e.clamp(0, wg.shape[0] - 1)
    rc = r.rank.clamp(max=C_dev - 1)
    token_idx = torch.arange(Tl, device=xl.device).repeat_interleave(k)
    contrib = xf[token_idx] * mine[:, None].to(xl.dtype)
    xe = torch.zeros((wg.shape[0], C_dev, d), dtype=xl.dtype, device=xl.device)
    xe = xe.index_put((le, rc), contrib, accumulate=True)

    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)
    w = (r.gate_w.reshape(Tl * k, 1) * mine[:, None]).to(ye.dtype)
    out = (ye[le, rc] * w).reshape(Tl, k, d).sum(1)

    # A term every rank of "model" computes alike (the aux loss, unsplit
    # shared experts, and everything when the experts are not split) is
    # contributed by model rank 0 only and joins the all-reduce as a partial
    # sum: its value is exact (the other ranks add zeros) and, with the
    # inputs' gradients summed over "model" (``local_view``), so is its
    # gradient.
    first = mesh.get_local_rank("model") == 0
    if not ep_sharded and not first:
        out = torch.zeros_like(out)
    sp = params.get("shared")
    if sp is not None and (shared_ff_sharded or first):
        sg, su = local(sp["w_gate"], sg_spec), local(sp["w_up"], sg_spec)
        sdn = local(sp["w_down"], sd_spec)
        # ff-split over the SAME axis, its partial sums ride the same
        # all-reduce as the routed experts (one collective in all)
        out = out + (F.silu(xf @ sg) * (xf @ su)) @ sdn

    x_pl = part.to_placements(x_spec, mesh)
    model = mesh.mesh_dim_names.index("model")
    out_pl = [Partial() if i == model else p for i, p in enumerate(x_pl)]
    out = DTensor.from_local(out.reshape(Bl, Sl, d), mesh, out_pl, run_check=False)
    out = out.redistribute(mesh, x_pl)  # the ONLY cross-model traffic
    # pmean over the data axes: psum, then / n
    aux_pl = [Partial() if name in dp_axes or name == "model" else Replicate()
              for name in mesh.mesh_dim_names]
    aux_l = aux_l if first else torch.zeros_like(aux_l)
    aux = DTensor.from_local(aux_l, mesh, aux_pl, run_check=False)
    aux = aux.redistribute(mesh, [Replicate()] * mesh.ndim) / float(dp_size)
    if isinstance(x, DTensor):
        return out, aux
    return out.full_tensor(), aux.full_tensor()
