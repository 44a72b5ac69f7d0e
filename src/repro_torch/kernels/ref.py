"""Plain PyTorch versions of the port's CUDA kernels (the correctness
oracles). Each mirrors its kernel's contract; the CPU path of
``kernels/ops.py`` runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card."""
from __future__ import annotations

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
    """(counts_out i32[P], bins i32[P]): ``counts_in + bincount(ids >= 0)``
    and ``clip(floor(log2 c) + 1, 0, num_bins - 1)`` (0 when c <= 0).
    int32 addition wraps, as the reference's does."""
    P = counts_in.shape[0]
    ids = torch.where(page_ids >= 0, page_ids.to(torch.int64), P)
    hist = torch.zeros(P + 1, dtype=torch.int32, device=counts_in.device)
    hist.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    counts = counts_in.to(torch.int32) + hist[:P]
    bins = torch.clamp(bit_length(torch.clamp(counts.to(torch.int64), min=0)), max=num_bins - 1)
    return counts, bins.to(torch.int32)


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
