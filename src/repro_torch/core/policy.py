"""The MaxMem per-epoch policy step (paper §3.1 + §3.2) as tensor functions.

Pipeline per epoch:
  1. fold sampled accesses into per-page counters (+ lazy cooling)   [bins]
  2. compute instantaneous FMMR per tenant, update EWMA              [fmmr]
  3. reallocate fast memory proportionally to distance from target   [fmmr]
     using half the migration budget
  4. intra-tenant rebalance with the other half
  5. apply the migrations: instantly, or through the bounded queue
  6. the invariant sentinel

Each step runs inside a ``tick.*`` span (``repro_torch.runtime.spans``): a
profiler range while one records, one check otherwise.

Victim selection is O(P) and exact: each (tenant, tier) candidate group is
histogrammed by clamped effective count, and prefix sums over the count
axis give a per-tenant cutoff plus a residual for the bucket the quota
lands in; ties within a bucket break by lowest page id.

Entry points:
  * ``epoch_step``  — sample -> policy -> apply on a ``PolicyState``.
  * ``multi_epoch`` — k epochs as a Python loop over the same body, with
    per-epoch telemetry stacked on a leading k axis.
  * ``policy_epoch`` / ``apply_plan`` — the bare policy on (pages, tenants)
    and a sampled count vector, then the plan committed to the metadata.

Bit-parity notes (the reference is the JAX package's ``core/policy.py``):
  * u32 values live in int64 and are masked where the reference wraps;
    ``eff.astype(int32)`` of a u32 count >= 2^31 wraps negative there, and
    :func:`_i32` reproduces it.
  * ``.at[i].add(..., mode="drop")`` is ``bins.tally`` and
    ``.at[i].set(..., mode="drop")`` a write into one spare slot that is
    sliced off; negative indices wrap once from the end first, as the
    reference's scatter normalises them.
  * Every scatter-set writes equal values for duplicate indices, so it is
    deterministic on the card.
  * The occupancy prefix sum keeps the reference's two branches: one packed
    16+16-bit u32 cumsum (with its wrap-heal) for P <= 65536, two separate
    cumsums above.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bins, fmmr
from repro_torch.core.faults import (
    SENTINEL_NAN,
    SENTINEL_OCCUPANCY,
    SENTINEL_ORPHAN,
    SENTINEL_OWNERSHIP,
    SENTINEL_QUEUE,
)
from repro_torch.core.sampler import sample_accesses
from repro_torch.core.tiling import tiled_cumsum
from repro_torch.core.types import (
    DIR_DEMOTE,
    DIR_NONE,
    DIR_PROMOTE,
    INT32_MAX,
    INT32_MIN,
    MASK32,
    TIER_FAST,
    TIER_NONE,
    TIER_SLOW,
    EpochStats,
    MigrationPlan,
    MigrationQueue,
    OwnerSegments,
    PageState,
    PolicyParams,
    PolicyState,
    QueueStats,
    TenantState,
    knob_f32,
    knob_max,
    pick,
)
from repro_torch.runtime.spans import span

# Effective counts at or above this value share one histogram bucket.
COUNT_CLAMP = 4096

# Occupancy prefix sums pack both member sets into one u32 scan up to this
# many pages (the reference's threshold).
PACKED_OCC_MAX_PAGES = 65536

_I64 = torch.int64


def _i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 value of a u32 held in int64 (two's-complement wrap)."""
    return ((x + 2**31) & MASK32) - 2**31


def _set_where(base: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """A copy of ``base`` with ``base.at[idx].set(value, mode="drop")``,
    where ``idx`` is in [0, len(base)] and len(base) means "drop". Every
    write stores the same value, so duplicate indices are deterministic."""
    n = base.shape[0]
    return torch.cat([base, base.new_zeros(1)]).index_fill(0, idx, value)[:n]


def _per_tenant_pages(pages: PageState, max_tenants: int, segs=None, owner_onehot=None):
    """(fast_pages[T], slow_pages[T]) holdings."""
    if segs is not None:
        tier_s = pages.tier[segs.order]
        fast = bins.seg_sums((tier_s == TIER_FAST).to(_I64), segs.start)
        slow = bins.seg_sums((tier_s == TIER_SLOW).to(_I64), segs.start)
        return fast, slow
    if owner_onehot is None:
        owner_onehot = _onehot(pages.owner, max_tenants)
    fast = (owner_onehot & (pages.tier == TIER_FAST)[None, :]).sum(dim=1)
    slow = (owner_onehot & (pages.tier == TIER_SLOW)[None, :]).sum(dim=1)
    return fast, slow


def _onehot(owner: torch.Tensor, T: int) -> torch.Tensor:
    return owner.to(_I64)[None, :] == torch.arange(T, device=owner.device)[:, None]


def _srch(sorted_rows: torch.Tensor, values: torch.Tensor, side: str) -> torch.Tensor:
    """Per-row ``searchsorted`` (the reference's vmapped jnp.searchsorted)."""
    return torch.searchsorted(sorted_rows, values[:, None].contiguous(), side=side)[:, 0]


def _rank_positions(cum: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Position of the (j+1)-th set entry of a mask from its prefix count
    ``cum``: ``searchsorted(cum, j + 1)``. The values are built from ``cum``
    so that under ``vmap`` (core/fleet.py) they are batched and contiguous,
    not an expanded view."""
    return torch.searchsorted(cum, (j + 1) + cum[:1] * 0, side="left")


def _select_victims(
    key, owner, slow_cand, fast_cand, hist_slow, hist_fast, cum_slow, cum_fast,
    pq, dq, owner_onehot, segs: Optional[OwnerSegments] = None,
):
    """(promote_mask, demote_mask) bool[P]: per tenant, exactly the ``pq[t]``
    hottest slow candidates and ``dq[t]`` coldest fast candidates."""
    T, C = hist_slow.shape
    P = key.shape[0]
    idx_t = torch.arange(T, device=key.device)

    # hot side: smallest count whose whole bucket fits under the quota
    total_slow = cum_slow[:, -1]
    v = total_slow - pq
    c_full = torch.where(v <= 0, 0, 1 + _srch(cum_slow, v, "left"))
    cum_at = cum_slow[idx_t, torch.clamp(c_full - 1, 0, C - 1)]
    above = total_slow - torch.where(c_full > 0, cum_at, 0)
    above = torch.where(c_full < C, above, 0)
    r_p = pq - above

    # cold side: largest count whose whole bucket fits
    n_full = _srch(cum_fast, dq, "right")
    below = cum_fast[idx_t, torch.clamp(n_full - 1, 0, C - 1)]
    below = torch.where(n_full > 0, below, 0)
    r_d = dq - below

    cf_pg, rp_pg = c_full[owner], r_p[owner]
    nf_pg, rd_pg = n_full[owner], r_d[owner]
    member_p = slow_cand & (key == cf_pg - 1) & (rp_pg > 0)
    member_d = fast_cand & (key == nf_pg) & (rd_pg > 0)

    if segs is not None:
        occ_p, occ_d = _occ_segments(member_p, member_d, owner, segs)
    elif P <= PACKED_OCC_MAX_PAGES:
        occ_p, occ_d = _occ_packed(member_p, member_d, owner, owner_onehot)
    else:
        # a 16-bit field wraps iff one tenant has >= 2^16 members in its
        # straddling bucket; both forms are computed and one is selected
        safe = torch.maximum(hist_slow.max(), hist_fast.max()) < (1 << 16)
        pk = _occ_packed(member_p, member_d, owner, owner_onehot)
        tp = _occ_twopass(member_p, member_d, owner, owner_onehot)
        occ_p = torch.where(safe, pk[0], tp[0])
        occ_d = torch.where(safe, pk[1], tp[1])

    promote = (slow_cand & (key >= cf_pg)) | (member_p & (occ_p <= rp_pg))
    demote = (fast_cand & (key < nf_pg)) | (member_d & (occ_d <= rd_pg))
    return promote, demote


def _heal(member, occ):
    """A member's 1-based position reads 0 only when its 16-bit field
    wrapped at exactly 2^16 members: restore the true position."""
    return torch.where(member & (occ == 0), 1 << 16, occ)


def _occ_segments(member_p, member_d, owner, segs: OwnerSegments):
    """In-bucket page-id-order positions (1-based) via owner segments: one
    global cumsum in owner-sorted order, minus each segment's offset.

    For P <= 65536 both member sets ride one packed u32 cumsum (promote low
    16 bits, demote high 16), reduced modulo 2^32 as the reference's u32
    scan wraps. Beyond that the global count can wrap mid-pool, so two
    separate cumsums are used."""
    P = member_p.shape[0]
    order, inv, start = segs.order, segs.inv, segs.start
    owner_s = owner[order]
    dev = member_p.device
    if P <= PACKED_OCC_MAX_PAGES:
        packed = member_p.to(_I64) + (member_d.to(_I64) << 16)
        cum = tiled_cumsum(packed[order]) & MASK32
        cum0 = torch.cat([torch.zeros(1, dtype=_I64, device=dev), cum])
        local = ((cum - cum0[start[owner_s]]) & MASK32)[inv]
        return _heal(member_p, local & 0xFFFF), _heal(member_d, local >> 16)
    zero = torch.zeros(1, dtype=_I64, device=dev)
    cum_p = tiled_cumsum(member_p[order].to(_I64))
    cum_d = tiled_cumsum(member_d[order].to(_I64))
    off = start[owner_s]
    occ_p = (cum_p - torch.cat([zero, cum_p])[off])[inv]
    occ_d = (cum_d - torch.cat([zero, cum_d])[off])[inv]
    return occ_p, occ_d


def _occ_packed(member_p, member_d, owner, owner_onehot):
    """In-bucket positions for both member sets via ONE per-tenant packed
    u32 prefix sum over the [T, P] one-hot."""
    P = member_p.shape[0]
    packed = member_p.to(_I64) + (member_d.to(_I64) << 16)
    rows = torch.where(owner_onehot, packed[None, :], 0)
    cum = (tiled_cumsum(rows, axis=1) & MASK32)[owner, torch.arange(P, device=owner.device)]
    return _heal(member_p, cum & 0xFFFF), _heal(member_d, cum >> 16)


def _occ_twopass(member_p, member_d, owner, owner_onehot):
    """Wrap-proof form: one prefix sum per member set."""
    P = member_p.shape[0]
    idx = torch.arange(P, device=owner.device)
    occ_p = tiled_cumsum((owner_onehot & member_p[None, :]).to(_I64), axis=1)[owner, idx]
    occ_d = tiled_cumsum((owner_onehot & member_d[None, :]).to(_I64), axis=1)[owner, idx]
    return occ_p, occ_d


def _pair_count(cum_slow, cum_fast, give, take, cap):
    """i64[T]: number of strictly-improving (hottest-slow, coldest-fast)
    rebalance pairs after the reallocation victims: the maximum over c of
    min(#slow hotter than c - give, #fast at most c - take), found at the
    crossing by a per-tenant binary search."""
    T, C = cum_slow.shape
    idx_t = torch.arange(T, device=cum_slow.device)
    total_slow = cum_slow[:, -1]
    h = cum_fast + cum_slow
    thr = total_slow + take - give
    c_star = _srch(h, thr, "left")
    g_lo = cum_fast[idx_t, torch.clamp(c_star - 1, min=0)] - take
    f_hi = total_slow - cum_slow[idx_t, torch.clamp(c_star, max=C - 1)] - give
    m = torch.maximum(
        torch.where(c_star > 0, g_lo, INT32_MIN), torch.where(c_star < C, f_hi, INT32_MIN)
    )
    return torch.minimum(torch.clamp(m, min=0), cap)


def _epoch_core(
    pages: PageState,
    tenants: TenantState,
    sampled: torch.Tensor,  # i64[P] (u32 values) sampled accesses this epoch
    params: PolicyParams,
    max_tenants: int,
    plan_size: int,
    count_clamp: int,
    collect_plan: bool,
    exclude: Optional[torch.Tensor] = None,  # bool[P] pages barred from selection
    segs: Optional[OwnerSegments] = None,
    scan: bool = False,
):
    """One policy epoch. Returns (pages, tenants, promote_mask, demote_mask,
    plan | None, stats); ``pages`` still carries pre-migration tiers.
    ``scan`` selects the EWMA's rounding of the reference's k-epoch scan
    (``fmmr.update_ewma``)."""
    P = pages.owner.shape[0]
    T = max_tenants
    C = count_clamp
    dev = pages.owner.device

    # ---- 1. per-tenant fast/slow sample counts (tier before migration) ----
    with span("tick.sums"):
        oh = _onehot(pages.owner, T) if segs is None else None
        is_fast = pages.tier == TIER_FAST
        is_slow = pages.tier == TIER_SLOW
        owner32 = pages.owner.to(_I64)
        if segs is not None:
            own_ok = pages.owner >= 0
            idx = torch.where(own_ok & is_fast, owner32, torch.where(own_ok, T + owner32, 2 * T))
            tbl = bins.tally(idx, 2 * T, sampled) & MASK32  # 2T: dropped
            s_fast, s_slow = tbl[:T], tbl[T:]
        else:
            zero = torch.zeros_like(sampled)
            s_fast = torch.where(oh & is_fast[None, :], sampled[None, :], zero).sum(1) & MASK32
            s_slow = torch.where(oh & is_slow[None, :], sampled[None, :], zero).sum(1) & MASK32
    with span("tick.bins"):
        pages, tenants, cooled, eff = bins.accumulate_and_count(
            pages, tenants, sampled, params.num_bins, owner_onehot=oh, segs=segs
        )

    # ---- 2. FMMR update ----------------------------------------------------
    with span("tick.fmmr"):
        now = fmmr.fmmr_now(s_fast.to(torch.float32), s_slow.to(torch.float32))
        ewma = fmmr.update_ewma(tenants.a_miss, now, params.ewma_lambda, scan=scan)
        ewma = torch.where(tenants.active, ewma, torch.zeros_like(ewma))
        tenants = tenants._replace(a_miss=ewma)

    # ---- per-(tenant, tier, clamped count) candidate histograms -----------
    with span("tick.hist"):
        is_owned = pages.owner >= 0
        owner = torch.clamp(owner32, min=0)
        slow_cand = is_owned & is_slow
        fast_cand = is_owned & is_fast
        if exclude is not None:
            slow_cand = slow_cand & ~exclude
            fast_cand = fast_cand & ~exclude
        key = torch.clamp(_i32(eff), max=C - 1)
        flat = torch.where(
            slow_cand, owner * C + key, torch.where(fast_cand, T * C + owner * C + key, 2 * T * C)
        )
        # the table read as 2T + 1 rows of C counts: its low counts stay on chip
        hist2 = bins.tally(flat, 2 * T * C + 1, width=C)
        hist_slow = hist2[: T * C].reshape(T, C)
        hist_fast = hist2[T * C : 2 * T * C].reshape(T, C)
        cum_slow = tiled_cumsum(hist_slow, axis=1)
        cum_fast = tiled_cumsum(hist_fast, axis=1)
        n_slow_cand = cum_slow[:, -1]
        n_fast_cand = cum_fast[:, -1]
        if exclude is None:
            fast_hold, slow_hold = n_fast_cand, n_slow_cand
        else:
            fast_hold, slow_hold = _per_tenant_pages(pages, T, segs=segs, owner_onehot=oh)

    with span("tick.fmmr"):
        # ---- 3. proportional reallocation (budget R/2) ---------------------
        free_fast = torch.clamp(
            params.fast_capacity - params.alloc_headroom - fast_hold.sum(), min=0
        )
        realloc_budget = params.migration_budget // 2
        band_need = pick(params.promote_band >= 0, params.promote_band, params.hysteresis)
        band_donor = pick(params.demote_band >= 0, params.demote_band, params.hysteresis)
        ra = fmmr.reallocate(
            tenants, fast_hold, free_fast, realloc_budget,
            fair_mode=params.fair_mode, hysteresis=params.hysteresis,
            need_band=band_need, donor_band=band_donor,
        )
        tenants = tenants._replace(flagged=ra.flagged)
        ra_moves = ra.give.sum() + ra.take.sum()
        # a true float32 division, as the reference's (``scalar / tensor`` in
        # torch multiplies by the reciprocal: two roundings)
        moves32 = torch.clamp(ra_moves, min=1).to(torch.float32)
        ra_scale = torch.where(
            ra_moves > realloc_budget,
            torch.div(torch.full_like(moves32, 1.0) * knob_f32(realloc_budget), moves32),
            torch.ones((), dtype=torch.float32, device=dev),
        )
        take2 = torch.floor(ra.take.to(torch.float32) * ra_scale).to(_I64)
        give2 = torch.floor(ra.give.to(torch.float32) * ra_scale).to(_I64)
        give2 = fmmr.clamp_gives(give2, tenants.arrival, free_fast + take2.sum())

        # ---- 4. intra-tenant rebalance (budget R/2; each pair = 2 moves) ---
        n_active = torch.clamp(tenants.active.sum(), min=1)
        rebal_share = (params.migration_budget - realloc_budget) // (2 * n_active)
        give_eff = torch.minimum(give2, n_slow_cand)
        take_eff = torch.minimum(take2, n_fast_cand)
        n_rebal = _pair_count(cum_slow, cum_fast, give_eff, take_eff, rebal_share)
        n_rebal = torch.where(tenants.active, n_rebal, 0)

    # ---- 5. quotas -> victim masks -> plan ---------------------------------
    with span("tick.victims"):
        promote_quota = give_eff + n_rebal
        demote_quota = take_eff + n_rebal
        promote_mask, demote_mask = _select_victims(
            key, owner, slow_cand, fast_cand, hist_slow, hist_fast,
            cum_slow, cum_fast, promote_quota, demote_quota, oh, segs,
        )

        plan = None
        if collect_plan:
            j = torch.arange(plan_size, dtype=_I64, device=dev)
            cum_p = tiled_cumsum(promote_mask.to(_I64))
            cum_d = tiled_cumsum(demote_mask.to(_I64))
            idx_p = _rank_positions(cum_p, j)
            idx_d = _rank_positions(cum_d, j)
            plan = MigrationPlan(
                promote=torch.where(j < cum_p[-1], idx_p, -1),
                demote=torch.where(j < cum_d[-1], idx_d, -1),
            )

        stats = EpochStats(
            fmmr_now=now,
            fmmr_ewma=ewma,
            fast_pages=fast_hold,
            slow_pages=slow_hold,
            promoted=torch.minimum(promote_quota, n_slow_cand),
            demoted=torch.minimum(demote_quota, n_fast_cand),
            cooled=cooled,
        )
    return pages, tenants, promote_mask, demote_mask, plan, stats


def _apply_masks(pages: PageState, promote_mask, demote_mask) -> PageState:
    """Metadata migration via the victim masks."""
    tier = torch.where(
        promote_mask, TIER_FAST, torch.where(demote_mask, TIER_SLOW, pages.tier)
    ).to(torch.int8)
    return pages._replace(tier=tier)


def policy_epoch(
    pages: PageState,
    tenants: TenantState,
    sampled: torch.Tensor,  # u32 values [P]: sampled accesses this epoch
    params: PolicyParams,
    *,
    max_tenants: int,
    plan_size: int,
    count_clamp: int = COUNT_CLAMP,
):
    """Returns (pages', tenants', MigrationPlan, EpochStats). Tiers in
    ``pages'`` are pre-migration; use :func:`apply_plan` to commit the plan."""
    sampled = sampled.to(_I64) & MASK32
    pages, tenants, _pm, _dm, plan, stats = _epoch_core(
        pages, tenants, sampled, params, max_tenants, plan_size, count_clamp,
        collect_plan=True,
    )
    return pages, tenants, plan, stats


def _apply_plan_core(pages: PageState, plan: MigrationPlan) -> PageState:
    P = pages.tier.shape[0]

    def kept(ids):
        # -1 padding must not wrap to P-1: it goes to the dropped slot P
        return torch.where((ids >= 0) & (ids < P), ids.to(_I64), P)

    tier = _set_where(pages.tier, kept(plan.promote), TIER_FAST)
    tier = _set_where(tier, kept(plan.demote), TIER_SLOW)
    return pages._replace(tier=tier)


def apply_plan(pages: PageState, plan: MigrationPlan) -> PageState:
    """Execute a migration plan on the metadata (the data movement is the
    caller's: a page pool and the ``page_move`` kernel)."""
    return _apply_plan_core(pages, plan)


# --------------------------------------------------------------------------
# Bounded-bandwidth asynchronous migration data plane.
# --------------------------------------------------------------------------

def _compact(mask, out_len: int, arrays, pads):
    """Stable-compact entries where ``mask`` holds to the front of fresh
    arrays of length ``out_len`` (the rest is dropped) by rank lookup."""
    cum = tiled_cumsum(mask.to(_I64))
    j = torch.arange(out_len, dtype=_I64, device=mask.device)
    idx = torch.clamp(_rank_positions(cum, j), max=mask.shape[0] - 1)
    keep = j < cum[-1]
    return [torch.where(keep, a[idx], torch.full_like(a[idx], pad)) for a, pad in zip(arrays, pads)]


def _real_depth(queue: MigrationQueue) -> torch.Tensor:
    """Occupied slots whose direction is +-1 (tombstones excluded)."""
    return ((queue.page >= 0) & (queue.direction != DIR_NONE)).sum()


def _inflight_mask(state: PolicyState) -> Optional[torch.Tensor]:
    """bool[P] pages with a queued migration (None when the queue is off)."""
    queue = state.queue
    if queue is None or queue.size == 0:
        return None
    P = state.pending.shape[0]
    idx = torch.where(queue.page >= 0, queue.page.to(_I64), P)
    return _set_where(torch.zeros(P, dtype=torch.bool, device=idx.device), idx, True)


def _queue_tick(
    queue: MigrationQueue,
    plan: MigrationPlan,
    pages: PageState,
    tenants: TenantState,
    params: PolicyParams,
    epoch: torch.Tensor,
):
    """Enqueue this epoch's selections, then drain the FIFO under the
    bandwidth/latency budget and commit the drained tier flips.

    Commit-on-completion; the thrashing guard cancels queued demotions whose
    heat bin rose (and entries whose page was freed); demotes drain before
    promotes, FIFO within each direction, promotes capped by free fast
    room; overflow drops the newest entries. Storm guards (admission,
    cooldown tombstones) are off by default."""
    Q = queue.size
    S = plan.promote.shape[0]
    W = Q + 2 * S
    P = pages.tier.shape[0]
    dev = pages.tier.device

    heat_bin = bins.bin_of(bins.effective_count(pages, tenants), params.num_bins)

    # ---- thrashing / ownership guard on the in-flight entries ------------
    occupied = queue.page >= 0
    real = occupied & (queue.direction != DIR_NONE)
    tomb = occupied & (queue.direction == DIR_NONE)
    qp = torch.clamp(queue.page.to(_I64), min=0)
    owned = pages.owner[qp] >= 0
    reheat = real & (queue.direction == DIR_DEMOTE) & (heat_bin[qp] > queue.heat)
    cancel = real & (~owned | reheat)
    cooldown = knob_max(params.demote_cooldown, 0)
    entomb = cancel & reheat & owned & (cooldown > 0)
    tomb_live = tomb & owned & (epoch < queue.complete_epoch)
    keep = (real & ~cancel) | entomb | tomb_live
    n_cancel = cancel.sum()

    # ---- enqueue: kept entries first (FIFO), then new demotes, promotes --
    lat = knob_max(params.migration_latency, 0)
    in_q = _set_where(
        torch.zeros(P, dtype=torch.bool, device=dev),
        torch.where(keep, queue.page.to(_I64), P), True,
    )

    def _dedupe(ids):
        return torch.where(in_q[torch.clamp(ids, min=0)], -1, ids)

    d_ids = _dedupe(plan.demote)
    p_ids = _dedupe(plan.promote)

    # ---- queue admission control (params.promote_admission) --------------
    depth_pre = real.sum()
    admission = params.promote_admission
    if not isinstance(admission, torch.Tensor) and admission < 0:
        cap = INT32_MAX
    else:
        sev = torch.clamp(
            torch.div(2 * n_cancel, torch.clamp(depth_pre, min=1), rounding_mode="floor"), 0, 2
        )
        base = torch.zeros_like(sev) + knob_max(admission, 0)
        cap = pick(admission < 0, INT32_MAX, torch.clamp(base >> sev, min=1))
    pv = p_ids >= 0
    p_ids = torch.where(pv & (tiled_cumsum(pv) <= cap), p_ids, -1)
    dv = d_ids >= 0
    d_ids = torch.where(dv & (tiled_cumsum(dv) <= cap), d_ids, -1)

    ep = epoch.reshape(1).to(torch.int32)

    def _new(ids, direction):
        v = ids >= 0
        pid = torch.clamp(ids, min=0)
        return (
            ids,
            torch.where(v, direction, 0).to(torch.int8),
            ep.expand(S),
            (ep + lat).to(torch.int32).expand(S),
            torch.where(v, heat_bin[pid], 0).to(torch.int8),
        )

    nd, npr = _new(d_ids, DIR_DEMOTE), _new(p_ids, DIR_PROMOTE)
    k_dir = torch.where(entomb, DIR_NONE, queue.direction).to(torch.int8)
    k_cmp = torch.where(entomb, epoch + cooldown, queue.complete_epoch).to(torch.int32)
    w_page = torch.cat([torch.where(keep, queue.page.to(_I64), -1), nd[0], npr[0]])
    w_dir = torch.cat([k_dir, nd[1], npr[1]])
    w_enq = torch.cat([queue.enqueue_epoch, nd[2], npr[2]])
    w_cmp = torch.cat([k_cmp, nd[3], npr[3]])
    w_heat = torch.cat([queue.heat, nd[4], npr[4]])
    n_new = (p_ids >= 0).sum() + (d_ids >= 0).sum()

    # ---- bounded drain: demotes first, FIFO within each direction --------
    cv = w_page >= 0
    elig = cv & (epoch >= w_cmp)
    bw = pick(params.migration_bandwidth < 0, INT32_MAX, params.migration_bandwidth)
    is_d = elig & (w_dir == DIR_DEMOTE)
    is_p = elig & (w_dir == DIR_PROMOTE)
    drain_d = is_d & (tiled_cumsum(is_d) <= bw)
    n_d = drain_d.sum()
    fast_occ = (pages.tier == TIER_FAST).sum()
    room = params.fast_capacity - params.alloc_headroom - (fast_occ - n_d)
    drain_p = is_p & (tiled_cumsum(is_p) <= torch.minimum(bw - n_d, room))
    n_p = drain_p.sum()

    # commit-on-completion: tier flips only for the drained entries
    tier = _set_where(pages.tier, torch.where(drain_d, w_page, P), TIER_SLOW)
    tier = _set_where(tier, torch.where(drain_p, w_page, P), TIER_FAST)
    pages = pages._replace(tier=tier)

    (drained_d_ids,) = _compact(drain_d, W, (w_page,), (-1,))
    (drained_p_ids,) = _compact(drain_p, W, (w_page,), (-1,))

    # ---- survivors back into the fixed queue; overflow drops the newest --
    left = cv & ~drain_d & ~drain_p
    n_drop = torch.clamp(left.sum() - Q, min=0)
    q_page, q_dir, q_enq, q_cmp, q_heat = _compact(
        left, Q, (w_page, w_dir, w_enq, w_cmp, w_heat), (-1, 0, 0, 0, 0)
    )
    new_queue = MigrationQueue(
        page=q_page.to(torch.int32), direction=q_dir, enqueue_epoch=q_enq,
        complete_epoch=q_cmp, heat=q_heat,
    )
    qstats = QueueStats(
        depth=((q_page >= 0) & (q_dir != DIR_NONE)).sum(),
        enqueued=n_new,
        drained_promote=n_p,
        drained_demote=n_d,
        cancelled=n_cancel,
        dropped=n_drop,
        drained_promote_ids=drained_p_ids,
        drained_demote_ids=drained_d_ids,
    )
    return pages, new_queue, qstats


def _commit(state, pages, tenants, pm, dm, plan, stats, params):
    """Apply this epoch's migrations: instantly (zero-capacity queue) or
    through the bounded queue tick. Returns (pages', queue', epoch', stats')."""
    queue = state.queue
    if queue is None or queue.size == 0:
        pages = _apply_masks(pages, pm, dm)
        epoch = None if state.epoch is None else state.epoch + 1
        return pages, queue, epoch, stats
    pages, queue, qstats = _queue_tick(queue, plan, pages, tenants, params, state.epoch)
    return pages, queue, state.epoch + 1, stats._replace(queue=qstats)


def _sentinel_bits(
    pages: PageState,
    tenants: TenantState,
    params: PolicyParams,
    max_tenants: int,
    qstats: Optional[QueueStats],
    depth_before: Optional[torch.Tensor],
) -> torch.Tensor:
    """Invariant-sentinel bitmask (core/faults.py SENTINEL_*) on the
    post-commit state; skipped (0) when ``params.sentinel`` is off."""
    dev = pages.tier.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    on = params.sentinel > 0
    if not isinstance(on, torch.Tensor) and not on:
        return zero

    def bit(cond, value):
        return torch.where(cond, value, zero)

    bits = bit((pages.tier == TIER_FAST).sum() > params.fast_capacity, SENTINEL_OCCUPANCY)
    owned = pages.owner >= 0
    placed = pages.tier != TIER_NONE
    bits = bits | bit((owned != placed).any(), SENTINEL_OWNERSHIP)
    own = torch.clamp(pages.owner.to(_I64), 0, max_tenants - 1)
    bits = bits | bit((owned & ~tenants.active[own]).any(), SENTINEL_ORPHAN)
    bits = bits | bit((~torch.isfinite(tenants.a_miss)).any(), SENTINEL_NAN)
    if qstats is not None and depth_before is not None:
        flow = (
            qstats.enqueued - qstats.drained_promote - qstats.drained_demote
            - qstats.cancelled - qstats.dropped
        )
        bits = bits | bit(qstats.depth != depth_before + flow, SENTINEL_QUEUE)
    return pick(on, bits, zero)


def _step(st: PolicyState, pending, params, max_tenants, plan_size, exact_sampling,
          collect_plan, z, scan: bool = False):
    """One fused epoch on ``st`` with the backlog ``pending``; ``scan`` for
    an epoch of ``multi_epoch`` or a fleet (see ``fmmr.update_ewma``)."""
    with span("tick.sample"):
        sampled = sample_accesses(st.rng, pending, params.sample_period, exact=exact_sampling,
                                  z=z)
    queue_mode = st.queue is not None and st.queue.size > 0
    with span("tick.queue"):
        depth_before = _real_depth(st.queue) if queue_mode else None
        exclude = _inflight_mask(st)
    pages, tenants, pm, dm, plan, stats = _epoch_core(
        st.pages, st.tenants, sampled, params, max_tenants, plan_size, COUNT_CLAMP,
        collect_plan=collect_plan or queue_mode, exclude=exclude, segs=st.segs, scan=scan,
    )
    with span("tick.queue"):
        pages, queue, epoch, stats = _commit(st, pages, tenants, pm, dm, plan, stats, params)
    with span("tick.sentinel"):
        sentinel = _sentinel_bits(pages, tenants, params, max_tenants, stats.queue, depth_before)
    with span("tick.sample"):  # the sampler's stage consumes the backlog
        drained = torch.zeros_like(pending)
    new_state = st._replace(
        pages=pages, tenants=tenants, pending=drained, queue=queue, epoch=epoch,
    )
    return new_state, plan, stats._replace(sentinel=sentinel)


def epoch_step(
    state: PolicyState,
    params: PolicyParams,
    *,
    max_tenants: int,
    plan_size: int,
    exact_sampling: bool = False,
    z: Optional[torch.Tensor] = None,
):
    """Fused policy tick: sample -> policy -> migrate.

    Consumes ``state.pending`` and returns (state', plan, stats) with
    ``pending`` zeroed and the migration applied to the metadata. The
    argument state is not modified (the generator in ``state.rng`` is
    shared and advances). ``z`` passes the sampler's standard-normal
    deviates in from outside."""
    return _step(state, state.pending, params, max_tenants, plan_size, exact_sampling, True, z)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2^32) of an int64 tensor (SWAR bit
    tricks; torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def clt_deviates(rng: torch.Generator, k: int, P: int, device) -> torch.Tensor:
    """f32[k, P] exactly standardised deviates: (popcount of 16 random bits
    - 8) / 2 has mean 0 and variance 1, as the reference's scan path."""
    bits = torch.randint(0, 1 << 16, (k, P), generator=rng, dtype=_I64, device=device)
    return (popcount32(bits).to(torch.float32) - 8.0) * 0.5


def _stack(trees, dim: int = 0):
    """Stack a list of equal-structured NamedTuples of tensors leafwise."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(trees, dim)
    return type(first)(*(_stack([t[i] for t in trees], dim) for i in range(len(first))))


def _trim_stats(stats: EpochStats) -> EpochStats:
    """Drop the telemetry leaves the sweep's record path never reads:
    ``cooled``, ``slow_pages`` and, in queue mode, the [W]-wide drained id
    lists, which dominate the telemetry copy. Only paths without a page
    pool trim (the pool is the one reader of the drained ids)."""
    if stats.queue is not None:
        stats = stats._replace(
            queue=stats.queue._replace(drained_promote_ids=None, drained_demote_ids=None)
        )
    return stats._replace(cooled=None, slow_pages=None)


def multi_epoch(
    state: PolicyState,
    params: PolicyParams,
    counts: Optional[torch.Tensor] = None,
    *,
    k: int,
    max_tenants: int,
    plan_size: int,
    exact_sampling: bool = False,
    collect_plans: bool = True,
    trim_stats: bool = False,
    z: Optional[torch.Tensor] = None,
):
    """``k`` fused epochs as a loop over the single-epoch body.

    ``counts``: None (consume the backlog, then idle), [P] (replayed every
    epoch) or [k, P]. Returns (state', plans, stats, flagged) with every
    per-epoch output stacked on a leading k axis; ``plans`` is None when
    ``collect_plans=False``. Without exact sampling the deviates are the
    popcount CLT deviates of :func:`clt_deviates` drawn from ``state.rng``,
    or ``z`` [k, P] passed in from outside. ``trim_stats`` drops the leaves
    :func:`_trim_stats` names."""
    P = state.pending.shape[0]
    dev = state.pending.device
    with span("tick.sample"):
        if counts is not None:
            counts = counts.to(device=dev, dtype=_I64) & MASK32
        if not exact_sampling and z is None:
            z = clt_deviates(state.rng, k, P, dev)
    plans, stats_k, flagged = [], [], []
    st = state
    for i in range(k):
        pending = st.pending
        if counts is not None:
            with span("tick.sample"):
                pending = (pending + (counts if counts.dim() == 1 else counts[i])) & MASK32
        st, plan, stats = _step(
            st, pending, params, max_tenants, plan_size, exact_sampling, collect_plans,
            None if z is None else z[i], scan=True,
        )
        plans.append(plan if collect_plans else None)
        stats_k.append(_trim_stats(stats) if trim_stats else stats)
        flagged.append(st.tenants.flagged)
    return st, _stack(plans), _stack(stats_k), torch.stack(flagged)
