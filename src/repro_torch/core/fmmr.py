"""FMMR measurement + proportional fast-memory reallocation (paper §3.1).

Functions on [T]-shaped tenant tensors. Semantics as the reference:
  * needers (a_miss > t_miss) receive  M_p = (a_miss/t_miss) / F_need * R
  * donors  (a_miss < t_miss, holding fast memory) give up
                                        M_p = (t_miss/a_miss) / F_surplus * R
  * a_miss == 0 donors: only the earliest arrival donates, taking all of R;
  * takes are capped at the donor's fast pages; gives at what is available,
    served FCFS by arrival (or equal-fraction in fair mode).

Bit-parity with the reference's float32 program: every formula keeps its
order of operations, each float32 sum over tenants runs left to right (as
XLA:CPU reduces a short vector) through :func:`fsum`, and the EWMA is one
fused multiply-add as XLA:CPU contracts it. A one-ulp change in ``a_miss``
against ``t * (1 + band)`` flips a needer/donor decision.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sampler import fma_f32
from repro_torch.core.types import INT32_MAX, TenantState

_EPS = float(np.float32(1e-9))


def fsum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis of a short vector, left to right from
    0.0, each partial sum rounded to float32. Same on the CPU and the card
    (``torch.sum`` reduces in a tree whose shape depends on the device)."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def fmmr_now(a_fast: torch.Tensor, a_slow: torch.Tensor) -> torch.Tensor:
    """Instantaneous FMMR; 0 when no samples."""
    tot = a_fast + a_slow
    return torch.where(tot > 0, a_slow / torch.clamp(tot, min=1.0), torch.zeros_like(tot))


def update_ewma(prev: torch.Tensor, now: torch.Tensor, lam: float) -> torch.Tensor:
    """``lam * now + (1 - lam) * prev`` as XLA:CPU computes it: the first
    product fused into the add."""
    lam32 = np.float32(lam)
    rest = prev * float(np.float32(1.0) - lam32)
    return fma_f32(now, float(lam32), rest)


class Realloc(NamedTuple):
    give: torch.Tensor  # i64[T] fast pages granted this epoch
    take: torch.Tensor  # i64[T] fast pages reclaimed this epoch
    flagged: torch.Tensor  # bool[T] needers that could not be served


def _scatter_perm(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros.at[order].set(values)`` for a permutation ``order``."""
    out = torch.zeros_like(values)
    out[order] = values
    return out


def _fcfs_grant(want: torch.Tensor, key: torch.Tensor, available) -> torch.Tensor:
    order = torch.argsort(key, stable=True)
    want_sorted = want[order]
    cum = torch.cumsum(want_sorted, 0)
    grant = torch.minimum(torch.clamp(available - (cum - want_sorted), min=0), want_sorted)
    return _scatter_perm(order, grant)


def reallocate(
    tenants: TenantState,
    fast_pages: torch.Tensor,  # i64[T] current fast-page holdings
    free_fast: torch.Tensor,  # i64[] unallocated fast slots
    budget: int,  # R: pages of reallocation bandwidth this epoch
    fair_mode: bool = False,
    hysteresis: float = 0.0,
    need_band=None,
    donor_band=None,
) -> Realloc:
    act = tenants.active
    a, t = tenants.a_miss, tenants.t_miss
    dev = a.device
    R = float(np.float32(budget))
    band = np.float32(hysteresis)
    nb = band if need_band is None else np.float32(need_band)
    db = band if donor_band is None else np.float32(donor_band)
    zero_f = torch.zeros_like(a)
    int_max = torch.full_like(tenants.arrival, INT32_MAX)

    need_mask = act & (a > t * float(np.float32(1.0) + nb))
    donor_mask = act & (a < t * float(np.float32(1.0) - db)) & (fast_pages > 0)
    zero_donor = donor_mask & (a <= _EPS)

    # --- takes -------------------------------------------------------------
    ratio_d = torch.where(donor_mask & ~zero_donor, t / torch.clamp(a, min=_EPS), zero_f)
    any_zero = zero_donor.any()
    arrival_key = torch.where(zero_donor, tenants.arrival, int_max)
    first_zero = torch.argmin(arrival_key)
    F_surplus = fsum(ratio_d)
    onehot = (torch.arange(a.shape[0], device=dev) == first_zero).to(torch.float32)
    take_frac = torch.where(
        any_zero,
        onehot * any_zero.to(torch.float32),
        torch.where(F_surplus > 0, ratio_d / torch.clamp(F_surplus, min=_EPS), zero_f),
    )
    take = torch.minimum(torch.floor(take_frac * R).to(torch.int64), fast_pages)
    take = torch.where(act, take, 0)

    # --- gives -------------------------------------------------------------
    ratio_n = torch.where(need_mask, a / torch.clamp(t, min=_EPS), zero_f)
    F_need = fsum(ratio_n)
    give_want = torch.where(
        F_need > 0, torch.floor(ratio_n / torch.clamp(F_need, min=_EPS) * R), zero_f
    ).to(torch.int64)

    available = free_fast + take.sum()
    total_want = give_want.sum()

    fcfs = _fcfs_grant(give_want, torch.where(need_mask, tenants.arrival, int_max), available)
    scale = torch.where(
        total_want > 0,
        torch.clamp(
            available.to(torch.float32) / torch.clamp(total_want, min=1).to(torch.float32),
            max=1.0,
        ),
        torch.zeros((), dtype=torch.float32, device=dev),
    )
    fair = torch.floor(give_want.to(torch.float32) * scale).to(torch.int64)
    give = fair if fair_mode else fcfs
    give = torch.where(act, give, 0)

    # don't take more than what gets redistributed
    excess = torch.clamp(take.sum() - torch.clamp(give.sum() - free_fast, min=0), min=0)
    order = torch.argsort(-take, stable=True)
    t_sorted = take[order]
    cum = torch.cumsum(t_sorted, 0)
    reduce_sorted = torch.minimum(torch.clamp(excess - (cum - t_sorted), min=0), t_sorted)
    take = _scatter_perm(order, t_sorted - reduce_sorted)

    # --- §3.4 fair sharing: with no needers, equalize the surplus ----------
    no_needers = ~need_mask.any()
    n_act = torch.clamp(act.sum(), min=1)
    share = torch.div(fast_pages.sum() + free_fast, n_act, rounding_mode="floor")
    trickle = max(budget // 8, 1)
    want_take_eq = torch.where(
        act & (a < t * float(np.float32(0.7))), torch.clamp(fast_pages - share, min=0), 0
    )
    want_give_eq = torch.where(act, torch.clamp(share - fast_pages, min=0), 0)

    def _scale(want, cap):
        tot = torch.clamp(fsum(want), min=1.0)
        return torch.floor(want * (torch.minimum(cap, tot) / tot)).to(torch.int64)

    matched = torch.clamp(
        torch.minimum(want_take_eq.sum(), want_give_eq.sum() + free_fast), max=trickle
    ).to(torch.float32)
    take_eq = _scale(want_take_eq.to(torch.float32), matched)
    give_eq = _scale(
        want_give_eq.to(torch.float32),
        torch.clamp((take_eq.sum() + free_fast).to(torch.float32), max=float(trickle)),
    )
    give = torch.where(no_needers, give_eq, give)
    take = torch.where(no_needers, take_eq, take)

    flagged = need_mask & (give == 0) & (give_want > 0)
    return Realloc(give=give, take=take, flagged=flagged)


def clamp_gives(give: torch.Tensor, arrival: torch.Tensor, available) -> torch.Tensor:
    """Greedy FCFS clamp so that sum(give) <= available."""
    key = torch.where(give > 0, arrival, torch.full_like(arrival, INT32_MAX))
    return _fcfs_grant(give, key, available)
