"""Batched decode over the tiered paged KV cache.

Per layer and step, as in the reference's ``serving/paged_model.py``:
  1. project q/k/v for the new token; write k/v into the current page slot
  2. update the page's Quest summaries (key max/min)
  3. score all pages of each sequence with the Quest upper bound
         score(p) = sum_h sum_d max(q_hd * kmax_pd, q_hd * kmin_pd)
     and select the top-``quest_pages`` pages (current page force-included)
  4. attend over the selected pages only, through ``ops.paged_attention``
  5. count the selected logical pages -> per-page access counts

Step 4 is where the port differs in form: the reference gathers the
selected pages and runs a masked softmax in jnp, the port hands the paged
attention kernel a block table built from the selection (see
``selection_table``), which has exactly the reference's token mask. Only the
order of the softmax's sums changes. An inactive lane masks every key; the
kernel returns 0 for such a row, the reference a uniform softmax over the
rows it gathers. In an MoE model that output decides which experts the
idle lanes take capacity from, so the port gives those lanes
``idle_attention``; a dense model never reads it (idle lanes' logits are
zeroed) and skips it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params, lm_head_weight, mlp_block
from repro_torch.kernels import ops

NEG_INF = -1e30


class PagedPools(NamedTuple):
    k: torch.Tensor  # [L, n_slots, page, nkv, dh]
    v: torch.Tensor
    kmax: torch.Tensor  # [L, n_slots, nkv, dh] f32
    kmin: torch.Tensor


def quest_select(q, kmx, kmn, slot_tables, valid_page, cur_p, k_sel: int):
    """The table positions [B, k_sel] of the pages each lane attends to: the
    Quest upper bound of every page, invalid pages at -1e30, the current
    page at +inf (so it is always ``sel[:, 0]``), in descending order with
    ties to the lower position, as ``lax.top_k`` orders them (a stable
    descending sort does; ``torch.topk`` does not promise it)."""
    B, n_p = slot_tables.shape
    nkv, dh = kmx.shape[1], kmx.shape[2]
    st = slot_tables.clamp(min=0).to(torch.int64)
    qg = q.reshape(B, nkv, -1, dh).float()
    hi = torch.einsum("bngd,bpnd->bpng", qg, kmx[st])
    lo = torch.einsum("bngd,bpnd->bpng", qg, kmn[st])
    score = torch.maximum(hi, lo).sum(dim=(2, 3))  # [B, n_p]
    score = torch.where(valid_page, score, torch.full_like(score, NEG_INF))
    is_cur = torch.arange(n_p, device=score.device)[None, :] == cur_p[:, None]
    score = torch.where(is_cur, torch.full_like(score, torch.inf), score)
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k_sel]


def selection_table(sel, slot_tables, valid_page, cur_slot, cur_off, active, page: int):
    """Block table and lengths for ``ops.paged_attention`` from a selection.

    Entries 0..k-2 hold the slots of the selected non-current pages that are
    valid (-1 otherwise), entry k-1 the current page's slot, and a lane's
    length is (k-1)*page + cur_off + 1 (0 when inactive). Every valid page
    before the current one is full, so this is the reference's token mask:
    full selected pages, the current page up to the new token, nothing else.
    """
    k = sel.shape[1]
    rest = sel[:, 1:]  # sel[:, 0] is the current page (score +inf)
    slots = torch.where(valid_page.gather(1, rest), slot_tables.gather(1, rest),
                        torch.full_like(rest, -1, dtype=slot_tables.dtype))
    table = torch.cat([slots, cur_slot[:, None].to(slot_tables.dtype)], dim=1)
    lens = torch.where(active, (k - 1) * page + cur_off + 1, torch.zeros_like(cur_off))
    return table.to(torch.int32).contiguous(), lens.to(torch.int32).contiguous()


def idle_attention(vp, slots, g: int):
    """The reference's attention output of lanes that mask every key:
    ``slots`` [n, k_sel] are the selected pages' slots of their tables
    clamped to slot 0; their V rows are gathered, and every score is the
    finite ``NEG_INF``, so the softmax is uniform. Weights of 1/N (N =
    selected pages x page rows) in float32, cast to the pool's dtype and
    summed in float32, as the reference's product does; the mean of each KV
    head is broadcast over its group. Returns [n, nkv * g, dh] float32."""
    n, k_sel = slots.shape
    _, page, nkv, dh = vp.shape
    rows = vp[slots].reshape(n, k_sel * page, nkv, dh)
    w = (torch.tensor(1.0) / (k_sel * page)).to(vp.dtype).float()
    mean = (rows.float() * w).sum(dim=1)  # [n, nkv, dh]
    return mean[:, :, None, :].expand(n, nkv, g, dh).reshape(n, nkv * g, dh)


@torch.no_grad()
def paged_decode_step(
    params,
    tokens: torch.Tensor,  # [B] int
    positions: torch.Tensor,  # [B] int (index of the token being generated)
    slot_tables: torch.Tensor,  # [B, n_p] int physical slots (-1 = no page)
    logical_tables: torch.Tensor,  # [B, n_p] int logical page ids (-1 = none)
    active: torch.Tensor,  # [B] bool
    pools: PagedPools,
    num_logical_pages: int = 0,
    cfg=None,
    quest_pages: int = 4,
):
    """Returns (logits [B, V] f32, pools (updated in place), access_counts
    [P_logical] i32). Inactive lanes write nothing, count nothing, and get
    zero logits."""
    B = tokens.shape[0]
    page = pools.k.shape[2]
    n_p = slot_tables.shape[1]
    dev = pools.k.device
    positions = positions.to(torch.int64)
    slot_tables = slot_tables.to(torch.int64)
    logical_tables = logical_tables.to(torch.int64)

    x = params["embed"][tokens.to(torch.int64)[:, None]].to(cfg.cdtype)  # [B, 1, d]
    cur_p = positions // page
    cur_off = positions % page
    cur_slot = slot_tables.gather(1, cur_p[:, None])[:, 0].clamp(min=0)
    seq_lens = torch.where(active, positions + 1, torch.zeros_like(positions))
    valid_page = (slot_tables >= 0) & (
        torch.arange(n_p, device=dev)[None, :] * page < seq_lens[:, None]
    )
    k_sel = min(quest_pages, n_p)
    # inactive lanes must not write: their clamped slot would be row 0. The
    # active (and, for MoE, inactive) lanes' indices are found once (one
    # host sync each); indexing with them, unlike with the mask, does not
    # wait for the device.
    lanes = torch.nonzero(active).squeeze(1)
    idle = torch.nonzero(~active).squeeze(1) if cfg.is_moe else lanes[:0]
    g = cfg.num_heads // cfg.num_kv_heads
    w_slot, w_off = cur_slot[lanes], cur_off[lanes]
    cos, sin = L.rope_cos_sin(positions[:, None], cfg.d_head, cfg.rope_theta)
    P = int(num_logical_pages)
    counts = torch.zeros(P + 1, dtype=torch.int32, device=dev)

    for l in range(cfg.num_layers):
        lp = layer_params(params, l)
        kp, vp, kmx, kmn = pools.k[l], pools.v[l], pools.kmax[l], pools.kmin[l]
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], h, cfg)  # q [B, 1, nh, dh]
        q = L.rotate(q, cos, sin)
        k = L.rotate(k, cos, sin)

        # ---- write the new token into its page slot -----------------------
        k_new = k[lanes, 0]
        kp[w_slot, w_off] = k_new.to(kp.dtype)
        vp[w_slot, w_off] = v[lanes, 0].to(vp.dtype)
        kmx[w_slot] = torch.maximum(kmx[w_slot], k_new.float())
        kmn[w_slot] = torch.minimum(kmn[w_slot], k_new.float())

        # ---- Quest selection, then attention over the selected pages -------
        sel = quest_select(q, kmx, kmn, slot_tables, valid_page, cur_p, k_sel)
        table, lens = selection_table(sel, slot_tables, valid_page, cur_slot, cur_off,
                                      active, page)
        o = ops.paged_attention(q[:, 0].to(kp.dtype).contiguous(), kp, vp, table, lens)
        if idle.numel():
            if l == 0:  # an idle lane's selection is the same in every layer:
                # all its scores are NEG_INF but its current page's
                idle_slots = slot_tables[idle].clamp(min=0).gather(1, sel[idle])
            o[idle] = idle_attention(vp, idle_slots, g).to(o.dtype)
        x = x + o.reshape(B, 1, -1).to(x.dtype) @ lp["attn"]["w_o"]

        # an MoE layer routes all B lanes, the inactive ones included, as the
        # reference does: capacity is per step and couples the lanes
        h2 = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + mlp_block(lp, h2, cfg)

        # ---- access accounting (selected logical pages) --------------------
        sel_logical = logical_tables.gather(1, sel)
        ok = (sel_logical >= 0) & active[:, None]
        idx = torch.where(ok, sel_logical, torch.full_like(sel_logical, P))
        counts.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), dtype=torch.int32,
                                                         device=dev))

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weight(params, cfg)).float()
    logits = torch.where(active[:, None], logits, torch.zeros_like(logits))
    return logits, pools, counts[:-1]
