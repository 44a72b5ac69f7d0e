"""Plain PyTorch versions of the port's CUDA kernels (the correctness
oracles). Each mirrors its kernel's contract; the CPU path of
``kernels/ops.py`` runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card."""
from __future__ import annotations

import math

import torch


def bit_length(c: torch.Tensor) -> torch.Tensor:
    """Significant bits of each value of an int64 tensor holding values in
    [0, 2^32), i.e. floor(log2 c) + 1 and 0 for c == 0: a binary search on
    shifts, integers only (a float32 log2 is inexact above 2^24)."""
    x = c
    n = torch.zeros_like(c)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) > 0
        n = n + big.to(c.dtype) * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0).to(c.dtype)


def hot_bins_ref(page_ids: torch.Tensor, counts_in: torch.Tensor, num_bins: int):
    """(counts_out i32[P], bins i32[P]): ``counts_in`` plus the bincount of
    the ids in [0, P) (others are ignored, as the reference's dense compare
    ignores them) and ``clip(floor(log2 c) + 1, 0, num_bins - 1)`` (0 when
    c <= 0). int32 addition wraps, as the reference's does."""
    P = counts_in.shape[0]
    ids = torch.where((page_ids >= 0) & (page_ids < P), page_ids.to(torch.int64), P)
    hist = torch.zeros(P + 1, dtype=torch.int32, device=counts_in.device)
    hist.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    counts = counts_in.to(torch.int32) + hist[:P]
    bins = torch.clamp(bit_length(torch.clamp(counts.to(torch.int64), min=0)), max=num_bins - 1)
    return counts, bins.to(torch.int32)


def tally_ref(idx: torch.Tensor, size: int, values=None, *, width=None) -> torch.Tensor:
    """int64[size]: ``zeros(size).at[idx].add(values, mode="drop")``, ones
    when ``values`` is None: a negative index wraps once from the end, one
    still outside [0, size) lands in a spare slot that is cut off. ``width``
    is the kernel's layout of the table on chip and changes nothing here."""
    if values is None:
        values = torch.ones_like(idx)
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    out = torch.zeros(size + 1, dtype=values.dtype, device=idx.device)
    # scatter_add, not index_add: under vmap (core/fleet.py) index_add's
    # batching rule loops over the machines; scatter_add's does not
    return out.scatter_add(0, idx, values)[:size]


def page_copy_ref(src_pool, dst_pool, src_ids, dst_ids):
    """``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]``, in place; returns
    ``dst_pool``. Ids are in range; padding entries point at a reserved
    trash row, whose final content is unspecified."""
    dst_pool[dst_ids.to(torch.int64)] = src_pool[src_ids.to(torch.int64)]
    return dst_pool


def page_move_ref(pool, src_ids, dst_ids):
    """Intra-pool moves ``pool[dst_ids[i]] = pool[src_ids[i]]``, in place,
    with gather semantics: every read sees the pre-plan pool (the gather
    completes before the scatter starts)."""
    pool[dst_ids.to(torch.int64)] = pool[src_ids.to(torch.int64)]
    return pool


# page_move_classes: the class of each plan entry in the CUDA kernel's schedule
MOVE_NONE, MOVE_A, MOVE_B, MOVE_S = 0, 1, 2, 3


def page_move_classes(src_ids, dst_ids, rows: int) -> torch.Tensor:
    """i64[m]: each entry's class in the CUDA ``page_move``'s schedule. An
    entry is *real* when its ids differ and both lie in [0, rows); others
    are ``MOVE_NONE``. A real entry is ``MOVE_A`` when no real entry reads
    its destination (copied in pass A), ``MOVE_B`` when some real entry
    reads its destination and none writes its source (copied in pass B),
    and ``MOVE_S`` otherwise (staged: read into scratch in pass A, written
    in pass B)."""
    s, d = src_ids.to(torch.int64), dst_ids.to(torch.int64)
    real = (s != d) & (s >= 0) & (s < rows) & (d >= 0) & (d < rows)
    read = torch.zeros(rows + 1, dtype=torch.bool, device=s.device)
    written = torch.zeros(rows + 1, dtype=torch.bool, device=s.device)
    read[torch.where(real, s, rows)] = True
    written[torch.where(real, d, rows)] = True
    read[rows] = written[rows] = False
    dst_read = read[torch.where(real, d, rows)]
    src_written = written[torch.where(real, s, rows)]
    cls = torch.where(dst_read, torch.where(src_written, MOVE_S, MOVE_B), MOVE_A)
    return torch.where(real, cls, MOVE_NONE)


def page_move_phased_ref(pool, src_ids, dst_ids, *, reverse: bool = False):
    """``page_move`` as the CUDA kernel schedules it, in place; returns
    ``pool``. Pass A copies the A entries and reads the S entries' sources
    into scratch; pass B then copies the B entries and writes the S entries
    from scratch; other entries do nothing. Within a pass the entries run
    one at a time, in plan order or (``reverse``) the other way: the card
    runs them in no order, so a pass that reads a row it also writes would
    show here as a difference between the two orders. Agrees with
    ``page_move_ref`` on every plan whose real destinations are distinct.
    Nothing on the main path calls it: it is the plain model of the
    kernel's schedule."""
    cls = page_move_classes(src_ids, dst_ids, pool.shape[0]).tolist()
    s, d = src_ids.tolist(), dst_ids.tolist()
    order = range(len(cls) - 1, -1, -1) if reverse else range(len(cls))
    scratch = {}
    for i in order:  # pass A
        if cls[i] == MOVE_A:
            pool[d[i]] = pool[s[i]]
        elif cls[i] == MOVE_S:
            scratch[i] = pool[s[i]].clone()
    for i in order:  # pass B
        if cls[i] == MOVE_B:
            pool[d[i]] = pool[s[i]]
        elif cls[i] == MOVE_S:
            pool[d[i]] = scratch[i]
    return pool


def flash_attention_ref(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """Causal GQA attention: q [B, nh, Sq, dh], k/v [B, nkv, Skv, dh] ->
    [B, nh, Sq, dh] in q's dtype. Query head h reads KV head h // (nh/nkv);
    queries are the last Sq positions of the key stream (suffix alignment,
    ``q_offset = Skv - Sq``); ``sliding_window`` > 0 keeps keys with
    ``k_pos > q_pos - sliding_window``. Scores, softmax and the products
    accumulate in float32; the probabilities are rounded to v's dtype
    before the product with v."""
    B, nh, Sq, dh = q.shape
    nkv, Skv = k.shape[1], k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, nkv, g, Sq, dh).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window:
        mask &= kpos > qpos - sliding_window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.matmul(p, v.float()[:, :, None])  # [B, nkv, g, Sq, dh]
    return out.reshape(B, nh, Sq, dh).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens):
    """One-token GQA decode attention over a block table: q [B, nh, dh],
    pools [P, page, nkv, dh], ``block_tables`` i32 [B, n_p] (-1 entries
    skipped), ``seq_lens`` i32 [B] (entry p holds ``clip(len - p*page, 0,
    page)`` valid tokens). Returns [B, nh, dh] in q's dtype; a row with no
    valid key returns 0. Float32 scores and softmax; the probabilities are
    rounded to v's dtype before the product with v."""
    B, nh, dh = q.shape
    _, page, nkv, _ = k_pages.shape
    n_p = block_tables.shape[1]
    g = nh // nkv
    tables = block_tables.clamp(min=0).to(torch.int64)
    k = k_pages[tables].reshape(B, n_p * page, nkv, dh).float()
    v = v_pages[tables].reshape(B, n_p * page, nkv, dh)
    qg = q.reshape(B, nkv, g, dh).float()
    s = torch.einsum("bngd,bknd->bngk", qg, k) / math.sqrt(dh)
    pos = torch.arange(n_p * page, device=q.device)[None, :]
    valid = pos < seq_lens.to(torch.int64)[:, None]
    valid &= (block_tables >= 0).repeat_interleave(page, dim=1)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0).to(v.dtype).float()
    out = torch.einsum("bngk,bknd->bngd", p, v.float())
    return out.reshape(B, nh, dh).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, seq_lens, n_split: int):
    """The split-K form of ``paged_attention_ref``, as the CUDA kernel
    computes it: split s covers table entries ``[s*per, min((s+1)*per,
    n_p))`` with ``per = ceil(n_p / n_split)``; each split keeps its own
    max ``m`` (-1e30 with no valid key), sum ``l`` of ``exp(s - m)`` and
    accumulator of the products with v of those probabilities rounded to
    v's dtype; the splits merge with the log-sum-exp rescale into
    ``acc / max(l, 1e-30)``. A split with no valid key adds weight 0; a row
    with none at all returns 0. Nothing on the main path calls it: it is
    the plain model of the kernel's merge."""
    B, nh, dh = q.shape
    _, page, nkv, _ = k_pages.shape
    n_p = block_tables.shape[1]
    g = nh // nkv
    per = max(1, -(-n_p // max(n_split, 1)))
    tables = block_tables.clamp(min=0).to(torch.int64)
    k = k_pages[tables].reshape(B, n_p * page, nkv, dh).float()
    v = v_pages[tables].reshape(B, n_p * page, nkv, dh)
    qg = q.reshape(B, nkv, g, dh).float()
    s = torch.einsum("bngd,bknd->bngk", qg, k) / math.sqrt(dh)
    pos = torch.arange(n_p * page, device=q.device)[None, :]
    valid = pos < seq_lens.to(torch.int64)[:, None]
    valid &= (block_tables >= 0).repeat_interleave(page, dim=1)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=q.device)
    ms, ls, accs = [], [], []
    for lo in range(0, n_split * per, per):
        cols = slice(lo * page, min(lo + per, n_p) * page)
        ok = valid[:, None, None, cols]
        sc = torch.where(ok, s[..., cols], neg)
        m = sc.amax(dim=-1, keepdim=True) if sc.shape[-1] else neg.expand(B, nkv, g, 1)
        e = torch.where(ok, torch.exp(sc - m), torch.zeros((), device=q.device))
        p = e.to(v.dtype).float()
        ms.append(m[..., 0])
        ls.append(e.sum(dim=-1))
        accs.append(torch.einsum("bngk,bknd->bngd", p, v[:, cols].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)  # split first
    w = torch.exp(m - m.amax(dim=0))
    out = (acc * w[..., None]).sum(dim=0) / torch.clamp((l * w).sum(dim=0), min=1e-30)[..., None]
    return out.reshape(B, nh, dh).to(q.dtype)
