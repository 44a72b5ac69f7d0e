"""MaxMem central manager + tenant handles (paper §3.3 user-space design).

    mgr = CentralManager(num_pages=..., fast_capacity=..., ...)  # on "cuda"
    h = mgr.register(t_miss=0.1)
    pages = mgr.allocate(h, n_pages)
    mgr.record_access(counts)             # engine reports page accesses
    stats = mgr.run_epoch()               # policy thread tick
    res = mgr.run_epochs(k, counts)       # k ticks
    mgr.set_target(h, 0.5)
    mgr.free(h, pages); mgr.unregister(h)

Allocation follows §3.1: fast first, slow if fast is exhausted, an error if
both are. The policy state lives on the manager's device in one
``PolicyState``; control-plane operations (register/allocate/free) are host
numpy and upload their result. The device is ``"cuda"`` unless the caller
asks for another (the tests pass ``device="cpu"``); without a GPU the
default raises instead of running on the CPU.

``phase_seconds`` accumulates host time per phase of the epochs: ``tick``
(the policy call, which on the card only enqueues work), ``sync`` (the
drained-id copies to the host, which wait for the tick to finish) and
``execute`` (the data plane's host loop, including its ``page_move``
launches). ``device_reads`` counts the blocking host reads of the state's
tensors, on every path. Each phase is also a span
(``repro_torch.runtime.spans``), seen under ``torch.profiler``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import policy
from repro_torch.core.dataplane import PagePool
from repro_torch.core.types import (
    BANDWIDTH_UNLIMITED,
    MASK32,
    TIER_FAST,
    TIER_NONE,
    TIER_SLOW,
    EpochStats,
    MigrationPlan,
    OwnerSegments,
    PageState,
    PolicyParams,
    PolicyState,
    TenantState,
    f32,
    segments_build_host,
    segments_update_host,
)
from repro_torch.runtime.spans import span


class TenantHandle(int):
    """Opaque tenant slot id (the libMaxMem connection analogue)."""


def resolve_device(device=None, what: str = "CentralManager") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and asking
    for the card where there is none raises, naming ``what`` asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class EpochResult:
    stats: EpochStats
    plan: Optional[MigrationPlan]
    flags: np.ndarray  # bool[T] tenants that could not be served

    def fmmr(self, h: int) -> float:
        return float(self.stats.fmmr_ewma[h])

    @property
    def migrated_pages(self) -> int:
        """Pages actually moved this epoch: queue drains in data-plane mode,
        plan selections otherwise."""
        q = self.stats.queue
        if q is not None:
            return int(q.drained_promote) + int(q.drained_demote)
        return int(self.plan.num_promote) + int(self.plan.num_demote)

    @property
    def queue_depth(self) -> int:
        q = self.stats.queue
        return 0 if q is None else int(q.depth)

    @property
    def queue_flow(self) -> Tuple[int, int, int]:
        """(enqueued, drained, cancelled) this epoch; zeros without a queue."""
        q = self.stats.queue
        if q is None:
            return (0, 0, 0)
        return (int(q.enqueued), int(q.drained_promote) + int(q.drained_demote), int(q.cancelled))


def _index_tree(tree, i):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(_index_tree(x, i) for x in tree))


@dataclasses.dataclass
class MultiEpochResult:
    """Stacked output of ``run_epochs``: every tensor has a leading k axis."""

    stats: EpochStats
    plans: Optional[MigrationPlan]
    flags: np.ndarray  # bool[k, T]

    def __len__(self) -> int:
        return self.flags.shape[0]

    def unstack(self) -> List[EpochResult]:
        return [
            EpochResult(
                stats=_index_tree(self.stats, i),
                plan=None if self.plans is None else _index_tree(self.plans, i),
                flags=self.flags[i],
            )
            for i in range(len(self))
        ]

    @property
    def migrated_per_epoch(self) -> np.ndarray:
        q = self.stats.queue
        if q is not None:
            return _np(q.drained_promote).astype(np.int64) + _np(q.drained_demote).astype(np.int64)
        return (_np(self.stats.promoted) + _np(self.stats.demoted)).sum(axis=1)

    @property
    def queue_depth_per_epoch(self) -> np.ndarray:
        q = self.stats.queue
        if q is None:
            return np.zeros(len(self), np.int64)
        return _np(q.depth).astype(np.int64)

    @property
    def queue_flow_per_epoch(self) -> np.ndarray:
        """i64[k, 3] (enqueued, drained, cancelled) per epoch."""
        q = self.stats.queue
        if q is None:
            return np.zeros((len(self), 3), np.int64)
        return np.stack(
            [
                _np(q.enqueued).astype(np.int64),
                _np(q.drained_promote).astype(np.int64) + _np(q.drained_demote).astype(np.int64),
                _np(q.cancelled).astype(np.int64),
            ],
            axis=1,
        )


class CentralManager:
    def __init__(
        self,
        num_pages: int,
        fast_capacity: int,
        migration_budget: int,
        max_tenants: int = 16,
        num_bins: int = 6,
        sample_period: int = 100,
        ewma_lambda: float = 0.5,
        fair_mode: bool = False,
        hysteresis: float = 0.08,
        seed: int = 0,
        exact_sampling: bool = False,
        queue_size: int = 0,
        migration_bandwidth: Optional[int] = None,
        migration_latency: int = 0,
        data_plane_elems: Optional[int] = None,
        sentinel: bool = False,
        alloc_headroom: int = 0,
        promote_band: float = -1.0,
        demote_band: float = -1.0,
        promote_admission: Optional[int] = None,
        demote_cooldown: int = 0,
        device=None,
    ):
        """Same knobs as the reference's manager, plus ``device`` (``None``
        = ``"cuda"``). ``queue_size > 0`` enables the bounded migration
        queue; ``data_plane_elems`` backs every page with that many float32
        elements of real content in a :class:`PagePool` whose migrations
        run through the ``page_move`` kernel."""
        if fast_capacity > num_pages:
            raise ValueError("fast_capacity exceeds num_pages")
        if migration_bandwidth is not None and queue_size == 0:
            raise ValueError(
                "finite migration_bandwidth requires the queue data plane: pass queue_size > 0"
            )
        if (promote_admission is not None or demote_cooldown) and queue_size == 0:
            raise ValueError(
                "promote_admission / demote_cooldown act on the migration queue: "
                "pass queue_size > 0"
            )
        self.device = resolve_device(device)
        self.num_pages = num_pages
        self.max_tenants = max_tenants
        # fleet hooks (core/fleet.py): the policy state sits behind a
        # property; any setter marks the machine mutated, and a fleet
        # dispatch parks the advanced state as a lazy slice of its stack
        self._state_val: Optional[PolicyState] = None
        self._state_thunk = None
        self._mutated = True
        self.params = PolicyParams(
            fast_capacity=int(fast_capacity),
            migration_budget=int(migration_budget),
            num_bins=int(num_bins),
            ewma_lambda=f32(ewma_lambda),
            sample_period=int(sample_period),
            fair_mode=bool(fair_mode),
            hysteresis=f32(hysteresis),
            migration_bandwidth=int(
                BANDWIDTH_UNLIMITED if migration_bandwidth is None else migration_bandwidth
            ),
            migration_latency=int(migration_latency),
            sentinel=1 if sentinel else 0,
            alloc_headroom=int(alloc_headroom),
            promote_band=f32(promote_band),
            demote_band=f32(demote_band),
            promote_admission=-1 if promote_admission is None else int(promote_admission),
            demote_cooldown=int(demote_cooldown),
        )
        self.plan_size = int(migration_budget)
        self.queue_size = int(queue_size)
        self._state = PolicyState.create(
            num_pages, max_tenants, seed=seed, queue_size=queue_size, device=self.device
        )
        # owner-sorted permutation, rebuilt lazily before the next tick;
        # incremental when the churn since the last build is known
        self._segs_owner: Optional[np.ndarray] = None
        self._segs_host = None
        self._segs_built_owner: Optional[np.ndarray] = None
        self._segs_delta: Optional[list] = None
        self._segs_ref = None
        self._refresh_segs(np.full((num_pages,), -1, np.int32))
        self._arrival_seq = 0
        self.exact_sampling = exact_sampling
        self.epoch_index = 0
        self._snap: Optional[Dict[str, np.ndarray]] = None
        self.queue_enqueued = 0
        self.queue_drained = 0
        self.queue_cancelled = 0
        self.queue_dropped = 0
        self.migration_failures = 0
        self.phase_seconds = {"tick": 0.0, "sync": 0.0, "execute": 0.0}
        self.device_reads = 0
        self.pool: Optional[PagePool] = None
        if data_plane_elems is not None:
            self.pool = PagePool(
                num_pages, fast_capacity, row_elems=data_plane_elems,
                plan_slots=max(2 * self.plan_size, 8), device=self.device,
            )

    # --------------------------------------------------------- state views
    @property
    def _state(self) -> PolicyState:
        if self._state_thunk is not None:
            self._state_val = self._state_thunk()
            self._state_thunk = None
        return self._state_val

    @_state.setter
    def _state(self, value: PolicyState) -> None:
        self._state_val = value
        self._state_thunk = None
        self._mutated = True

    def _set_fleet_state(self, thunk) -> None:
        """Park the machine's advanced state as a lazy slice of a fleet's
        stacked state (core/fleet.py): ``thunk()`` materialises it the
        first time a control-plane or telemetry path reads it. Until a
        setter fires, the fleet knows this machine's row of its stack is
        current and skips the upload. The slice's segments are new
        tensors, so ``_segs_ref`` no longer matches them and the next
        ownership change rebuilds the permutation from scratch."""
        self._state_val = None
        self._state_thunk = thunk
        self._mutated = False

    @property
    def pages(self) -> PageState:
        return self._state.pages

    @pages.setter
    def pages(self, value: PageState) -> None:
        self._state = self._state._replace(pages=value)
        self._snap = None
        self._refresh_segs(self._read(value.owner))

    def _set_pages_churn(self, value: PageState, changed_ids) -> None:
        self._state = self._state._replace(pages=value)
        self._snap = None
        self._refresh_segs(self._read(value.owner), changed=changed_ids)

    @property
    def tenants(self) -> TenantState:
        return self._state.tenants

    @tenants.setter
    def tenants(self, value: TenantState) -> None:
        self._state = self._state._replace(tenants=value)

    def _refresh_segs(self, owner: np.ndarray, changed=None) -> None:
        """Note an ownership change; ``changed`` (the mutated page ids) lets
        the lazy rebuild patch the permutation instead of re-sorting."""
        self._segs_owner = np.asarray(owner)
        if changed is None:
            self._segs_delta = None
        elif self._segs_delta is not None:
            self._segs_delta.append(np.asarray(changed, np.int64))

    def _ensure_segs(self) -> None:
        if self._segs_owner is None:
            return
        cur = self._segs_owner
        T = self.max_tenants
        host = None
        segs = self._state.segs
        if (
            self._segs_delta is not None
            and self._segs_host is not None
            and self._segs_built_owner is not None
            and segs is not None
            and segs.order is self._segs_ref
        ):
            if self._segs_delta:
                ids = np.unique(np.concatenate(self._segs_delta))
            else:
                ids = np.empty((0,), np.int64)
            ids = ids[self._segs_built_owner[ids] != cur[ids]]
            if ids.size == 0:
                host = self._segs_host
            else:
                host = segments_update_host(*self._segs_host, self._segs_built_owner, cur, ids, T)
        if host is None:
            host = segments_build_host(cur, T)
        if host is not self._segs_host:
            self._state = self._state._replace(
                segs=OwnerSegments.from_host(*host, device=self.device)
            )
        self._segs_host = host
        self._segs_built_owner = cur
        self._segs_ref = self._state.segs.order
        self._segs_delta = []
        self._segs_owner = None

    def _snapshot(self) -> Dict[str, np.ndarray]:
        """Host copy of the page metadata (one transfer per epoch)."""
        if self._snap is None:
            pg = self._state.pages
            self._snap = {"tier": self._read(pg.tier), "owner": self._read(pg.owner)}
        return self._snap

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """Host copy of a state tensor: a blocking read, counted."""
        self.device_reads += 1
        return _np(t)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------- tenants
    def register(self, t_miss: float) -> TenantHandle:
        if not 0.0 < t_miss <= 1.0:
            raise ValueError("t_miss must be in (0, 1] (§3.1)")
        free = np.flatnonzero(~self._read(self.tenants.active))
        if len(free) == 0:
            raise RuntimeError("tenant table full")
        slot = int(free[0])
        t = TenantState(*(x.clone() for x in self.tenants))
        t.active[slot] = True
        t.t_miss[slot] = f32(t_miss)
        t.a_miss[slot] = 0.0
        t.arrival[slot] = self._arrival_seq
        t.cool_epoch[slot] = 0
        t.flagged[slot] = False
        self.tenants = t
        self._arrival_seq += 1
        return TenantHandle(slot)

    def set_target(self, h: TenantHandle, t_miss: float) -> None:
        if not 0.0 < t_miss <= 1.0:
            raise ValueError("t_miss must be in (0, 1]")
        t_m = self.tenants.t_miss.clone()
        t_m[int(h)] = f32(t_miss)
        self.tenants = self.tenants._replace(t_miss=t_m)

    def unregister(self, h: TenantHandle) -> None:
        owned = np.flatnonzero(self._snapshot()["owner"] == int(h))
        if len(owned):
            self.free(h, owned)
        self.tenants = self.tenants.clear_slot(int(h))

    # ------------------------------------------------------------- memory
    def allocate(self, h: TenantHandle, n_pages: int) -> np.ndarray:
        """First-touch allocation: fast while available, then slow (§3.1)."""
        snap = self._snapshot()
        tier = snap["tier"]
        owner = snap["owner"]
        unalloc = np.flatnonzero(tier == TIER_NONE)
        if len(unalloc) < n_pages:
            raise MemoryError(
                f"tenant {int(h)}: out of tiered memory "
                f"({n_pages} requested, {len(unalloc)} free)"
            )
        fast_used = int((tier == TIER_FAST).sum())
        fast_room = max(self.params.fast_capacity - fast_used, 0)
        take = unalloc[:n_pages]
        n_fast = min(fast_room, n_pages)
        new_tier = tier.copy()
        new_owner = owner.copy()
        new_tier[take[:n_fast]] = TIER_FAST
        new_tier[take[n_fast:]] = TIER_SLOW
        new_owner[take] = int(h)
        self._set_pages_churn(
            self.pages._replace(tier=self._upload(new_tier), owner=self._upload(new_owner)),
            take,
        )
        if self.pool is not None:
            self.pool.on_allocate(take, new_tier[take])
        return take

    def free(self, h: TenantHandle, page_ids: Sequence[int]) -> None:
        ids = np.asarray(page_ids, np.int64)
        snap = self._snapshot()
        owner = snap["owner"]
        if not np.all(owner[ids] == int(h)):
            raise PermissionError("tenant freeing pages it does not own")
        tier = snap["tier"].copy()
        owner = owner.copy()
        tier[ids] = TIER_NONE
        owner[ids] = -1
        count = self._read(self.pages.count).copy()
        count[ids] = 0
        last_cool = self._read(self.pages.last_cool).copy()
        last_cool[ids] = 0
        self._set_pages_churn(
            self.pages._replace(
                tier=self._upload(tier), owner=self._upload(owner),
                count=self._upload(count), last_cool=self._upload(last_cool),
            ),
            ids,
        )
        pending = self._read(self._state.pending).copy()
        pending[ids] = 0
        self._state = self._state._replace(pending=self._upload(pending))
        # scrub queued migrations of the freed pages now: the slots may be
        # re-allocated before the next tick
        queue = self._state.queue
        if queue is not None and queue.size:
            qp = self._read(queue.page)
            qd = self._read(queue.direction)
            stale = (qp >= 0) & np.isin(qp, ids)
            if stale.any():
                self.queue_cancelled += int((stale & (qd != 0)).sum())
                qp = qp.copy()
                qp[stale] = -1
                qd = qd.copy()
                qd[stale] = 0
                self._state = self._state._replace(
                    queue=queue._replace(page=self._upload(qp), direction=self._upload(qd))
                )
        if self.pool is not None:
            self.pool.on_free(ids)

    # ------------------------------------------------------------- accesses
    def record_access(self, counts) -> None:
        """Engine-side access report: exact per-page access counts since the
        last call (numpy array or tensor), folded into the backlog on the
        device modulo 2^32 (the reference's u32 add)."""
        with span("record"):
            if isinstance(counts, torch.Tensor):
                c = counts.to(device=self.device, dtype=torch.int64) & MASK32
            else:
                c = self._upload(np.asarray(counts).astype(np.uint32, copy=False).astype(np.int64))
            self._state = self._state._replace(pending=(self._state.pending + c) & MASK32)

    # ------------------------------------------------------------- epoch
    def _fold_queue_stats(self, q) -> None:
        self.queue_enqueued += int(self._read(q.enqueued.sum()))
        self.queue_drained += int(self._read(q.drained_promote.sum() + q.drained_demote.sum()))
        self.queue_cancelled += int(self._read(q.cancelled.sum()))
        self.queue_dropped += int(self._read(q.dropped.sum()))

    def _pool_execute(self, dem_ids, pro_ids, failed_dem: set, failed_pro: set) -> None:
        """Run one drained batch through the pool, folding fault outcomes."""
        with span("dataplane", self.phase_seconds, "execute"):
            self.pool.execute(dem_ids, pro_ids)
        if self.pool.fault_injector is None:
            return
        fd, fp = self.pool.last_failed
        dem = np.asarray(dem_ids).ravel()
        pro = np.asarray(pro_ids).ravel()
        ok = set(dem[dem >= 0].tolist()) | set(pro[pro >= 0].tolist())
        ok -= set(fd.tolist()) | set(fp.tolist())
        failed_dem -= ok
        failed_pro -= ok
        failed_dem.update(fd.tolist())
        failed_pro.update(fp.tolist())

    def _revert_failed_moves(self, failed_dem: set, failed_pro: set) -> None:
        """Commit-on-completion fallback: a page whose move was abandoned
        stays in its source tier."""
        if not failed_dem and not failed_pro:
            return
        tier = self._read(self.pages.tier).copy()
        if failed_dem:
            tier[list(failed_dem)] = TIER_FAST
        if failed_pro:
            tier[list(failed_pro)] = TIER_SLOW
        self._state = self._state._replace(pages=self.pages._replace(tier=self._upload(tier)))
        self._snap = None
        self.migration_failures += len(failed_dem) + len(failed_pro)

    def _sync_ids(self, *ids: torch.Tensor) -> List[np.ndarray]:
        """Copy drained id lists to the host (waits for the tick)."""
        with span("epoch.sync", self.phase_seconds, "sync"):
            return [self._read(x) for x in ids]

    def run_epoch(self) -> EpochResult:
        """Policy-thread tick: sample -> policy -> migrate."""
        with span("epoch"):
            self._ensure_segs()
            with span("tick", self.phase_seconds, "tick"):
                self._state, plan, stats = policy.epoch_step(
                    self._state, self.params, max_tenants=self.max_tenants,
                    plan_size=self.plan_size, exact_sampling=self.exact_sampling,
                )
            self.epoch_index += 1
            self._snap = None
            fd, fp = set(), set()
            if self.pool is not None:
                ids = (plan.demote, plan.promote) if stats.queue is None else (
                    stats.queue.drained_demote_ids, stats.queue.drained_promote_ids)
                dem, pro = self._sync_ids(*ids)
                self._pool_execute(dem, pro, fd, fp)
            with span("epoch.stats"):
                if stats.queue is not None:
                    self._fold_queue_stats(stats.queue)
                self._revert_failed_moves(fd, fp)
                flags = self._read(self._state.tenants.flagged)
        return EpochResult(stats=stats, plan=plan, flags=flags)

    def run_epochs(
        self, k: int, counts=None, collect_plans: bool = False
    ) -> MultiEpochResult:
        """Run ``k`` policy epochs. ``counts``: None (consume the recorded
        backlog, then idle), [P] (replayed every epoch) or [k, P]."""
        with span("epoch"):
            self._ensure_segs()
            c = None
            if counts is not None:
                if isinstance(counts, torch.Tensor):
                    c = counts.to(device=self.device, dtype=torch.int64) & MASK32
                else:
                    c = self._upload(
                        np.asarray(counts).astype(np.uint32, copy=False).astype(np.int64))
            with span("tick", self.phase_seconds, "tick"):
                self._state, plans, stats, flagged = policy.multi_epoch(
                    self._state, self.params, c, k=k, max_tenants=self.max_tenants,
                    plan_size=self.plan_size, exact_sampling=self.exact_sampling,
                    collect_plans=collect_plans or (self.pool is not None and not self.queue_size),
                )
            self.epoch_index += k
            self._snap = None
            fd, fp = set(), set()
            if self.pool is not None:
                ids = (plans.demote, plans.promote) if stats.queue is None else (
                    stats.queue.drained_demote_ids, stats.queue.drained_promote_ids)
                dem, pro = self._sync_ids(*ids)
                for i in range(k):
                    self._pool_execute(dem[i], pro[i], fd, fp)
            with span("epoch.stats"):
                if stats.queue is not None:
                    self._fold_queue_stats(stats.queue)
                self._revert_failed_moves(fd, fp)
                flags = self._read(flagged)
        return MultiEpochResult(stats=stats, plans=plans, flags=flags)

    # ------------------------------------------------------- data plane
    @property
    def migration_bounded(self) -> bool:
        return self.queue_size > 0 and self.params.migration_bandwidth >= 0

    def set_migration_bandwidth(self, pages_per_epoch: Optional[int]) -> None:
        """Bound the migration drain (None = unlimited); needs the queue."""
        if pages_per_epoch is not None and self.queue_size == 0:
            raise ValueError(
                "finite migration_bandwidth requires the queue data plane: "
                "construct CentralManager(queue_size > 0)"
            )
        self.params = self.params._replace(
            migration_bandwidth=BANDWIDTH_UNLIMITED if pages_per_epoch is None
            else int(pages_per_epoch)
        )

    def set_migration_latency(self, epochs: int) -> None:
        self.params = self.params._replace(migration_latency=int(epochs))

    # --------------------------------------------------- faults & sentinel
    def set_sentinel(self, on: bool) -> None:
        self.params = self.params._replace(sentinel=1 if on else 0)

    def set_fault_injector(self, injector) -> None:
        """Attach a ``core.faults.FaultInjector`` to the page data plane."""
        if self.pool is None:
            raise ValueError(
                "data-plane fault injection requires a page pool: construct "
                "CentralManager(data_plane_elems=...)"
            )
        self.pool.set_fault_injector(injector)

    def poison_telemetry(self, kind: str = "tier") -> None:
        """Corrupt one cell of the policy state: ``"tier"`` unplaces the
        first owned page, ``"nan"`` puts a NaN into an active tenant's EWMA."""
        snap = self._snapshot()
        if kind == "tier":
            owned = np.flatnonzero(snap["owner"] >= 0)
            if len(owned) == 0:
                raise RuntimeError("no owned pages to poison")
            tier = snap["tier"].copy()
            tier[owned[0]] = TIER_NONE
            self._state = self._state._replace(pages=self.pages._replace(tier=self._upload(tier)))
            self._snap = None
        elif kind == "nan":
            act = np.flatnonzero(self._read(self.tenants.active))
            if len(act) == 0:
                raise RuntimeError("no active tenants to poison")
            a = self.tenants.a_miss.clone()
            a[int(act[0])] = float("nan")
            self.tenants = self.tenants._replace(a_miss=a)
        else:
            raise ValueError(f"unknown poison kind: {kind!r}")

    def queue_depth(self) -> int:
        """In-flight migrations (cooldown tombstones excluded)."""
        queue = self._state.queue
        if queue is None or not queue.size:
            return 0
        return int(self._read(((queue.page >= 0) & (queue.direction != 0)).sum()))

    def queue_counters(self) -> Dict[str, int]:
        """Cumulative counters: enqueued == drained + cancelled + dropped + depth."""
        return {
            "enqueued": self.queue_enqueued,
            "drained": self.queue_drained,
            "cancelled": self.queue_cancelled,
            "dropped": self.queue_dropped,
            "depth": self.queue_depth(),
        }

    # ------------------------------------------------------------- telemetry
    def tiers(self) -> np.ndarray:
        """i8[P] tier of every page (cached host snapshot)."""
        return self._snapshot()["tier"]

    def owners(self) -> np.ndarray:
        """i16[P] owner of every page (cached host snapshot)."""
        return self._snapshot()["owner"]

    def fast_pages_of(self, h: TenantHandle) -> int:
        snap = self._snapshot()
        return int(((snap["owner"] == int(h)) & (snap["tier"] == TIER_FAST)).sum())

    def tier_of(self, page_ids) -> np.ndarray:
        return self._snapshot()["tier"][np.asarray(page_ids)]

    def fmmr_of(self, h: TenantHandle) -> float:
        return float(self._read(self.tenants.a_miss[int(h)]))

