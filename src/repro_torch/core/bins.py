"""Hotness bins with lazy cooling (paper §3.2) on dense per-page counters.

    bin(count) = 0                                   if count == 0
               = min(floor(log2(count)) + 1, num_bins - 1)

Bin k >= 1 holds counts in [2^(k-1), 2^k). When any page of a tenant would
exceed 2^(num_bins-1) all of that tenant's pages halve, lazily: a per-tenant
``cool_epoch`` counter and a per-page ``last_cool`` stamp give a page's
effective count as ``count >> (cool_epoch - last_cool)``.

Counts are u32 values held in int64 (``types`` module docstring); every sum
that the reference wraps modulo 2^32 is masked with ``MASK32``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.tiling import tiled_cumsum
from repro_torch.core.types import MASK32, OwnerSegments, PageState, TenantState
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import bit_length


def tally(idx: torch.Tensor, size: int, values: Optional[torch.Tensor] = None, *,
          width: Optional[int] = None) -> torch.Tensor:
    """int64[size]: ``zeros(size).at[idx].add(values, mode="drop")``, ones
    when ``values`` is None (``ops.tally``: on the card, the ``tally``
    kernel). The fleet's vmapped tick (core/fleet.py) passes functorch
    batched tensors, which a ctypes kernel cannot take: they keep
    ``ref.tally_ref``'s ``scatter_add``, whose batching rule batches."""
    if any(t is not None and torch._C._functorch.is_batchedtensor(t) for t in (idx, values)):
        return ref.tally_ref(idx, size, values)
    return ops.tally(idx, size, values, width=width)


def seg_sums(values_sorted: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Per-tenant segment sums of an owner-sorted value array: one global
    cumsum plus two [T+1] gathers (exact for integers)."""
    cum = tiled_cumsum(values_sorted)
    cum0 = torch.cat([torch.zeros(1, dtype=cum.dtype, device=cum.device), cum])
    return cum0[start[1:]] - cum0[start[:-1]]


def bin_of(count: torch.Tensor, num_bins) -> torch.Tensor:
    """Heat-bin id (int64) for (effective) counts, read as u32 values.
    ``num_bins`` is an int or a 0-d integer tensor (a fleet's machine)."""
    c = count.to(torch.int64) & MASK32
    fl = bit_length(c) - 1  # floor(log2(c)); -1 for c == 0 (torch has no clz)
    if isinstance(num_bins, torch.Tensor):
        return torch.minimum(torch.clamp(fl + 1, min=0), num_bins - 1)
    return torch.clamp(fl + 1, 0, num_bins - 1)


def cool_threshold(num_bins):
    """Counts >= 2^(num_bins-1) trigger a tenant-wide cooling event."""
    if isinstance(num_bins, torch.Tensor):
        return torch.bitwise_left_shift(torch.ones_like(num_bins), num_bins - 1) & MASK32
    return (1 << (num_bins - 1)) & MASK32


def effective_count(pages: PageState, tenants: TenantState) -> torch.Tensor:
    """Apply pending (lazy) cooling: count >> cooling events since last touch."""
    owner = torch.clamp(pages.owner.to(torch.int64), min=0)
    pend = torch.clamp(tenants.cool_epoch[owner].to(torch.int64) - pages.last_cool, min=0)
    pend = torch.clamp(pend, max=31)
    eff = pages.count >> pend
    return torch.where(pages.owner >= 0, eff, torch.zeros_like(eff))


def accumulate_and_count(
    pages: PageState,
    tenants: TenantState,
    sampled: torch.Tensor,  # i64[P] (u32 values) sampled accesses this epoch
    num_bins,
    owner_onehot: Optional[torch.Tensor] = None,  # bool[T, P]
    segs: Optional[OwnerSegments] = None,
) -> Tuple[PageState, TenantState, torch.Tensor, torch.Tensor]:
    """Fold one epoch of samples into the counters; fire cooling if needed.

    Returns (pages, tenants, cooled bool[T], eff i64[P]) where ``eff`` is the
    effective count on the new state."""
    T = tenants.cool_epoch.shape[0]
    eff = effective_count(pages, tenants)
    new_count = (eff + sampled) & MASK32
    touched = sampled > 0
    owner = torch.clamp(pages.owner.to(torch.int64), min=0)
    cool_at_owner = tenants.cool_epoch[owner]

    count1 = torch.where(touched, new_count, pages.count)
    last1 = torch.where(touched, cool_at_owner, pages.last_cool)

    over = touched & (new_count >= cool_threshold(num_bins)) & (pages.owner >= 0)
    if segs is not None:
        cooled = tally(torch.where(over, owner, T), T) > 0  # T: dropped
    else:
        if owner_onehot is None:
            owner_onehot = pages.owner.to(torch.int64)[None, :] == torch.arange(
                T, device=owner.device
            )[:, None]
        cooled = (owner_onehot & over[None, :]).any(dim=1)
    cool_epoch2 = tenants.cool_epoch + cooled.to(torch.int32)

    cooled_pg = cooled[owner]
    do_halve = cooled_pg & touched
    count2 = torch.where(do_halve, count1 >> 1, count1)
    last2 = torch.where(touched, cool_epoch2[owner], last1)

    pages2 = pages._replace(count=count2, last_cool=last2)
    tenants2 = tenants._replace(cool_epoch=cool_epoch2)
    eff_new = torch.where(do_halve, count1 >> 1, torch.where(touched, count1, eff))
    eff_new = torch.where(~touched & cooled_pg, eff_new >> 1, eff_new)
    eff_new = torch.where(pages.owner >= 0, eff_new, torch.zeros_like(eff_new))
    return pages2, tenants2, cooled, eff_new


def accumulate_samples(
    pages: PageState,
    tenants: TenantState,
    sampled: torch.Tensor,  # i64[P] (u32 values) sampled accesses this epoch
    num_bins,
) -> Tuple[PageState, TenantState, torch.Tensor]:
    """Compatibility wrapper around :func:`accumulate_and_count`; returns
    (pages, tenants, cooled bool[T])."""
    pages2, tenants2, cooled, _ = accumulate_and_count(pages, tenants, sampled, num_bins)
    return pages2, tenants2, cooled


def count_histogram(
    values: torch.Tensor,  # integer [P] per-page bucket keys (clamped to num_buckets-1)
    owner: torch.Tensor,  # integer [P] tenant slot; entries with mask False ignored
    mask: torch.Tensor,  # bool[P] which pages participate
    num_buckets: int,
    max_tenants: int,
) -> torch.Tensor:
    """[T, num_buckets] int32 page counts per (tenant, bucket), built by one
    scatter-add in O(P); prefix sums over the bucket axis then give exact
    victim ranks without a sort."""
    key = torch.clamp(values.to(torch.int64), max=num_buckets - 1)
    flat = torch.where(mask, owner.to(torch.int64) * num_buckets + key,
                       max_tenants * num_buckets)
    hist = torch.zeros(max_tenants * num_buckets + 1, dtype=torch.int32, device=flat.device)
    hist = hist.scatter_add(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist[:-1].reshape(max_tenants, num_buckets)


def heat_histogram(pages: PageState, tenants: TenantState, num_bins: int,
                   max_tenants: int) -> torch.Tensor:
    """[T, num_bins] page counts per (tenant, bin): the heat gradient."""
    b = bin_of(effective_count(pages, tenants), num_bins)
    return count_histogram(b, pages.owner, pages.owner >= 0, num_bins, max_tenants)
