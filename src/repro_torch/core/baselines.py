"""Baseline tiered-memory policies the paper compares against (§5).

A copy of the JAX package's ``core/baselines.py``: host numpy, no device
state, the same numpy PCG64 stream (``default_rng(seed)``, the shuffles in
``HeMemStatic.run_epoch`` and ``AutoNUMALike.run_epoch``), so the
placements replay ``tests/golden/baseline_traces.json`` bit for bit.

All expose the CentralManager surface the simulator drives:
  register / set_target / unregister / allocate / free /
  record_access / run_epoch / pages / num_pages / fmmr_of

* HeMemStatic  — per-tenant *static* fast partitions, each managed by an
  independent HeMem-style instance: single hotness *threshold* (not a heat
  gradient); among qualifying pages victims are arbitrary, so hot and warm
  pages compete blindly for the partition (paper Fig. 3: ~30% of MaxMem when
  hot+warm exceed DRAM). Partitions cannot help other tenants (Fig. 8).
* AutoNUMALike — tenant-blind global promotion of recently-touched pages,
  LRU-ish demotion, effectively unbounded churn; no QoS.
* TwoLM       — Optane 2LM/Memory-Mode analogue: fast tier as a direct-mapped
  cache; resident page per set = most recently dominant accessor. No QoS.

Vectorized NumPy implementations (DESIGN.md §3): every per-epoch step is
array ops over cached ownership groupings — no per-page Python loops and no
per-tenant full-pool mask passes — so the baselines run the same 256k+ page
scenarios as the fused MaxMem engine. Placements are bit-identical to the
seed per-page implementations (``benchmarks/seed_baselines_frozen.py``),
locked by ``tests/golden/baseline_traces.json``: victim "arbitrariness" is
the same RNG shuffle sequence, applied per tenant in registration order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.types import TIER_FAST, TIER_NONE, TIER_SLOW


@dataclasses.dataclass
class _Pages:
    owner: np.ndarray
    tier: np.ndarray
    count: np.ndarray


def _segment_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Start offsets of each run of equal values in a sorted key array."""
    n = len(sorted_keys)
    if n == 0:
        return np.zeros(0, np.int64)
    boundary = np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return np.flatnonzero(boundary)


class _BaselineBase:
    def __init__(self, num_pages: int, fast_capacity: int, seed: int = 0):
        self.num_pages = num_pages
        self.fast_capacity = fast_capacity
        self.pages = _Pages(
            owner=np.full(num_pages, -1, np.int32),
            tier=np.full(num_pages, TIER_NONE, np.int8),
            count=np.zeros(num_pages, np.int64),
        )
        self._pending = np.zeros(num_pages, np.int64)
        self._next = 0
        self.rng = np.random.default_rng(seed)
        self._ewma: Dict[int, float] = {}
        self._groups_dirty = True  # ownership changed since the last epoch
        self._order: Optional[np.ndarray] = None
        self._sorted_owner: Optional[np.ndarray] = None

    # --- tenancy ------------------------------------------------------------
    def register(self, t_miss: float) -> int:
        h = self._next
        self._next += 1
        self._ewma[h] = 0.0
        return h

    def set_target(self, h: int, t_miss: float) -> None:
        pass  # no QoS

    def unregister(self, h: int) -> None:
        mine = self.pages.owner == h
        self.pages.owner[mine] = -1
        self.pages.tier[mine] = TIER_NONE
        self.pages.count[mine] = 0
        # drop QoS telemetry with the tenant: a departed handle must read as
        # fresh (fmmr_of == 0.0), not replay its last EWMA forever
        self._ewma.pop(h, None)
        self._groups_dirty = True

    def allocate(self, h: int, n_pages: int) -> np.ndarray:
        free = np.flatnonzero(self.pages.tier == TIER_NONE)
        if len(free) < n_pages:
            raise MemoryError("out of tiered memory")
        take = free[:n_pages]
        fast_used = int((self.pages.tier == TIER_FAST).sum())
        room = max(self._fast_room(h, fast_used), 0)
        # the quota may over-commit; the physical fast tier cannot
        n_fast = min(room, max(self.fast_capacity - fast_used, 0), n_pages)
        self.pages.tier[take[:n_fast]] = TIER_FAST
        self.pages.tier[take[n_fast:]] = TIER_SLOW
        self.pages.owner[take] = h
        self._groups_dirty = True
        return take

    def free(self, h: int, ids: Sequence[int]) -> None:
        ids = np.asarray(ids)
        self.pages.owner[ids] = -1
        self.pages.tier[ids] = TIER_NONE
        self.pages.count[ids] = 0
        self._groups_dirty = True

    def record_access(self, counts: np.ndarray) -> None:
        self._pending += counts

    # --- ownership grouping (cached between control-plane changes) ----------
    def _groups(self):
        """Page ids sorted by owner (stable => ascending ids within a
        tenant), plus per-owner segment offsets; recomputed only after
        allocate/free/unregister."""
        if self._groups_dirty:
            self._order = np.argsort(self.pages.owner, kind="stable")
            so = self.pages.owner[self._order]
            self._sorted_owner = so
            self._seg_starts = _segment_starts(so)
            self._seg_owners = so[self._seg_starts]
            self._groups_dirty = False
        return self._order, self._sorted_owner

    def _tenant_pages(self, h: int) -> np.ndarray:
        """Ascending page ids owned by ``h`` — one binary search, no mask."""
        order, so = self._groups()
        lo = np.searchsorted(so, h, side="left")
        hi = np.searchsorted(so, h, side="right")
        return order[lo:hi]

    # telemetry surface shared with CentralManager (simulator batch reads)
    def tiers(self) -> np.ndarray:
        return self.pages.tier

    def owners(self) -> np.ndarray:
        return self.pages.owner

    def fmmr_of(self, h: int) -> float:
        return self._ewma.get(h, 0.0)

    def _update_fmmr(self, tp: Optional[np.ndarray] = None):
        """EWMA of the slow-tier access share: two segment reduceats over
        the cached ownership grouping — O(P) total, independent of tenant
        count, instead of the seed's O(P) mask passes per tenant. Sums are
        sequential int64 (exact), so the EWMA values match the seed
        bit-for-bit."""
        if not self._ewma:
            return
        if tp is None:
            tp = np.flatnonzero(self._pending > 0)
        if len(tp) * 4 <= self.num_pages:
            # sparse epoch: only touched pages contribute to the sums (int64
            # values are exact in the f64 bincount accumulator)
            ow = self.pages.owner[tp]
            owned = ow >= 0
            ow = ow[owned].astype(np.int64)
            pend = self._pending[tp][owned].astype(np.float64)
            tots = np.bincount(ow, weights=pend, minlength=self._next)
            slows = np.bincount(
                ow, weights=pend * (self.pages.tier[tp][owned] == TIER_SLOW),
                minlength=self._next,
            )
            for h in self._ewma:
                cur = slows[h] / tots[h] if tots[h] > 0 else 0.0
                self._ewma[h] = 0.5 * cur + 0.5 * self._ewma[h]
            return
        order, _ = self._groups()
        ps = self._pending[order]
        slow_ps = ps * (self.pages.tier[order] == TIER_SLOW)
        tots = np.add.reduceat(ps, self._seg_starts)
        slows = np.add.reduceat(slow_ps, self._seg_starts)
        seg_of = {int(h): i for i, h in enumerate(self._seg_owners) if h >= 0}
        for h in self._ewma:
            i = seg_of.get(h)
            cur = slows[i] / tots[i] if i is not None and tots[i] > 0 else 0.0
            self._ewma[h] = 0.5 * cur + 0.5 * self._ewma[h]

    def _fast_room(self, h: int, fast_used: int) -> int:
        return self.fast_capacity - fast_used

    # result shim (simulator reads .plan.num_promote/num_demote)
    class _Plan:
        def __init__(self, p, d):
            self.num_promote = p
            self.num_demote = d

    class _Result:
        def __init__(self, p, d):
            self.plan = _BaselineBase._Plan(p, d)


class HeMemStatic(_BaselineBase):
    """Static partitions + per-partition hotness threshold."""

    def __init__(
        self,
        num_pages: int,
        fast_capacity: int,
        partitions: Optional[Dict[int, int]] = None,
        hot_threshold: int = 8,
        migration_budget: int = 2048,
        seed: int = 0,
    ):
        super().__init__(num_pages, fast_capacity, seed)
        self.partitions = dict(partitions or {})
        self.hot_threshold = hot_threshold
        self.migration_budget = migration_budget

    def set_partition(self, h: int, fast_pages: int):
        self.partitions[h] = fast_pages

    def _fast_room(self, h: int, fast_used: int) -> int:
        quota = self.partitions.get(h, 0)
        mine = self._tenant_pages(h)
        mine_fast = int((self.pages.tier[mine] == TIER_FAST).sum())
        return quota - mine_fast

    def run_epoch(self):
        self._update_fmmr()
        count = self.pages.count
        np.right_shift(count, 1, out=count)  # crude cooling, in place
        np.add(count, self._pending, out=count)
        self._pending[:] = 0
        tier = self.pages.tier
        promoted = demoted = 0
        budget = self.migration_budget
        # static partitions may over-commit (sum of quotas > fast_capacity);
        # the physical fast tier is still finite, so promotions are globally
        # clamped to the actual free fast slots as well as the quota
        fast_free = self.fast_capacity - int((tier == TIER_FAST).sum())
        # per-tenant work is O(tenant pages) on the cached grouping — the
        # only O(P) passes this epoch are the cooling update above
        for h in list(self._ewma):
            mine = self._tenant_pages(h)
            quota = self.partitions.get(h, 0)
            t_loc = tier[mine]
            hot_loc = count[mine] >= self.hot_threshold
            fast_loc = t_loc == TIER_FAST
            hot_slow = mine[(t_loc == TIER_SLOW) & hot_loc]
            cold_fast = mine[fast_loc & ~hot_loc]
            # victims arbitrary among qualifying (no heat gradient): shuffle
            self.rng.shuffle(hot_slow)
            n_fast = int(fast_loc.sum())
            room = quota - n_fast
            if room < len(hot_slow):  # evict arbitrary cold pages first
                evict = cold_fast[: min(len(cold_fast), len(hot_slow) - room, budget)]
                tier[evict] = TIER_SLOW
                demoted += len(evict)
                budget -= len(evict)
                fast_free += len(evict)
                room = quota - (n_fast - len(evict))
            promo = hot_slow[: max(min(room, budget, fast_free, len(hot_slow)), 0)]
            tier[promo] = TIER_FAST
            promoted += len(promo)
            budget -= len(promo)
            fast_free -= len(promo)
            if budget <= 0:
                break
        return self._Result(promoted, demoted)


class AutoNUMALike(_BaselineBase):
    """Tenant-blind promotion of recently-touched pages; no QoS, heavy churn.

    ``migration_budget=None`` (the default, and the golden-trace
    configuration) migrates every qualifying page like real autonuma
    balancing under no rate limit; an integer bounds total moves per epoch
    (promotions + evictions), which is how the scenario engine's
    ``SetMigrationBandwidth`` event reaches instant-apply baselines."""

    def __init__(self, num_pages: int, fast_capacity: int, seed: int = 0,
                 migration_budget: Optional[int] = None):
        super().__init__(num_pages, fast_capacity, seed)
        self.migration_budget = migration_budget

    def run_epoch(self):
        recent = self._pending
        touched = recent > 0
        tp = np.flatnonzero(touched)
        self._update_fmmr(tp)
        # FAST/SLOW tiers imply ownership (unallocated pages are TIER_NONE),
        # so the seed's owner>=0 conjunct is redundant
        fast = self.pages.tier == TIER_FAST
        slow = self.pages.tier == TIER_SLOW
        touched_slow = tp[slow[tp]]
        idle_fast = np.flatnonzero(fast & ~touched)
        self.rng.shuffle(touched_slow)
        self.rng.shuffle(idle_fast)
        free_fast = self.fast_capacity - int(fast.sum())
        want = len(touched_slow)
        if self.migration_budget is None:
            # demote idle pages to make room (autonuma demotion to CPUless
            # node); unbounded = the bit-exact golden-trace path
            need_evict = max(want - free_fast, 0)
            evict = idle_fast[:need_evict]
            n_promo = free_fast + len(evict)
        else:
            # promotions into free room cost 1 move, beyond it 2 (evict +
            # promote); fill free room first, then pair within the budget
            b = int(self.migration_budget)
            p_free = min(want, free_fast, b)
            paired = min(want - p_free, len(idle_fast), max(b - p_free, 0) // 2)
            evict = idle_fast[:paired]
            n_promo = p_free + paired
        self.pages.tier[evict] = TIER_SLOW
        demoted = len(evict)
        promo = touched_slow[:n_promo]
        self.pages.tier[promo] = TIER_FAST
        promoted = len(promo)
        self._pending[tp] = 0  # pending is nonzero exactly at tp
        return self._Result(promoted, demoted)


class TwoLM(_BaselineBase):
    """Direct-mapped hardware cache (Optane Memory Mode) analogue."""

    def __init__(self, num_pages: int, fast_capacity: int, seed: int = 0):
        super().__init__(num_pages, fast_capacity, seed)
        self._cache_dirty = True
        self._grouped: Optional[np.ndarray] = None  # owned ids grouped by set
        self._starts: Optional[np.ndarray] = None  # group start offsets
        self._group_of: Optional[np.ndarray] = None  # group index per element
        self._residents: Optional[np.ndarray] = None  # page per set, last epoch

    def allocate(self, h, n_pages):
        self._cache_dirty = True
        return super().allocate(h, n_pages)

    def free(self, h, ids):
        self._cache_dirty = True
        super().free(h, ids)

    def unregister(self, h):
        self._cache_dirty = True
        super().unregister(h)

    def _set_groups(self):
        """Owned page ids grouped by cache set (page % fast_capacity),
        ascending ids within a group; rebuilt only on ownership changes."""
        if self._cache_dirty:
            F = max(self.fast_capacity, 1)
            owned = np.flatnonzero(self.pages.owner >= 0)
            sets = owned % F
            order = np.argsort(sets, kind="stable")
            self._grouped = owned[order]
            self._starts = _segment_starts(sets[order])
            self._group_of = np.zeros(len(owned), np.int64)
            self._group_of[self._starts] = 1
            self._group_of = np.cumsum(self._group_of) - 1
            # all-idle resident per set (max page id: every score ties at 0)
            # and the page -> group index map for the sparse update path
            ends = np.append(self._starts[1:], len(owned)) - 1
            self._idle_res = self._grouped[ends] if len(owned) else None
            self._page_group = np.full(self.num_pages, -1, np.int64)
            self._page_group[self._grouped] = self._group_of
            self._residents = None  # tier no longer "residents FAST, rest SLOW"
            self._cache_dirty = False
        return self._grouped, self._starts, self._group_of

    def run_epoch(self):
        tp = np.flatnonzero(self._pending > 0)
        self._update_fmmr(tp)
        grouped, starts, group_of = self._set_groups()
        tier = self.pages.tier
        if not len(grouped):
            moved = int((tier == TIER_FAST).sum())
            tier[tier == TIER_FAST] = TIER_SLOW
            self._residents = None
            self._pending[:] = 0
            return self._Result(moved // 2, moved // 2)
        # resident page per set = max recent score, tie -> largest page id
        # (the seed's last-write-wins over its stable lexsort order)
        touched = tp[self._page_group[tp] >= 0]
        if len(touched) * 4 <= len(grouped):
            # sparse epoch: untouched sets keep their all-idle resident (max
            # page id); only sets with accessed members need the argmax
            residents = self._idle_res.copy()
            if len(touched):
                g = self._page_group[touched]
                sc = self._pending[touched]
                # (group, score, id) lexicographic order via ONE composite
                # int64 sort (np.lexsort costs 3 indirect sorts); the guard
                # keeps group*span + score*P + id below 2^63
                span = (int(sc.max()) + 1) * np.int64(self.num_pages)
                if span <= (1 << 62) // (int(g.max()) + 1):
                    v = np.sort(g * span + sc * np.int64(self.num_pages) + touched)
                    gs = v // span
                    last = np.empty(len(v), bool)
                    last[-1] = True
                    last[:-1] = gs[1:] != gs[:-1]
                    residents[gs[last]] = (v[last] % span) % self.num_pages
                else:  # astronomically hot pages: exact but slower
                    o = np.lexsort((touched, sc, g))
                    gs = g[o]
                    last = np.empty(len(o), bool)
                    last[-1] = True
                    last[:-1] = gs[1:] != gs[:-1]
                    residents[gs[last]] = touched[o][last]
        else:
            score = self._pending[grouped]
            best = np.maximum.reduceat(score, starts)
            is_best = score == best[group_of]
            cand = np.where(is_best, grouped, -1)
            residents = np.maximum.reduceat(cand, starts)
        if self._residents is None:
            # ownership changed since the last epoch (fast-first allocation
            # may have scattered FAST pages anywhere): rebuild from scratch
            new_tier = np.full_like(tier, TIER_SLOW)
            new_tier[tier == TIER_NONE] = TIER_NONE
            new_tier[residents] = TIER_FAST
            moved = int((new_tier != tier).sum())
            self.pages.tier = new_tier
        else:
            # steady state: exactly the previous residents are FAST, so the
            # delta is the per-set resident swaps — O(sets), not O(P)
            changed = self._residents != residents
            tier[self._residents[changed]] = TIER_SLOW
            tier[residents[changed]] = TIER_FAST
            moved = 2 * int(changed.sum())
        self._residents = residents
        self._pending[tp] = 0  # pending is nonzero exactly at tp
        return self._Result(moved // 2, moved // 2)
