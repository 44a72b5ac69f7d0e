"""Tiered-memory colocation simulator (drives the paper-figure benchmarks).

The simulator runs GUPS/KVS-like tenant workloads against a placement policy
(MaxMem's CentralManager or a baseline from ``core.baselines``) and evaluates
a machine cost model each epoch:

  * per-access latency  = hit * lat_fast + miss * lat_slow(load)
  * slow-tier load      = sum of tenant miss traffic + migration traffic;
                          latency scales by demand/capacity when saturated
  * tenant throughput   = threads / avg_latency  (closed-loop, fixed point)
  * tail latencies      = quantiles of the two-point access mixture with a
                          migration-interference term (write-protect stalls)

Constants are published-order-of-magnitude (DRAM ~80ns/100GB/s, Optane
~300ns/30GB/s read, I/OAT ~4GB/s/chan; TPU profile: HBM 819GB/s vs host DMA
~50GB/s). The *policies* are exact; the cost model only needs to rank them,
matching the paper's qualitative claims.

A copy of the JAX package's ``core/simulator.py``. The cost model stays host
numpy in float64 and the access noise a numpy PCG64 stream, so with exact
sampling a run on the port replays the reference's epoch history. The
backend may hold its state on the card (the port's ``CentralManager``):
telemetry tensors are brought to the host in one transfer each, per epoch
or per chunk.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import TIER_FAST, TIER_SLOW


def _host(x) -> np.ndarray:
    """A backend's array on the host: a tensor (on any device) in one
    transfer, anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class TierSpec:
    latency_ns: float
    bandwidth_GBps: float


@dataclass(frozen=True)
class MachineSpec:
    fast: TierSpec
    slow: TierSpec
    page_bytes: int = 2 << 20  # 2 MB huge pages (paper granularity)
    migration_GBps: float = 4.0  # I/OAT DMA engine class
    access_bytes: int = 64  # one cache line per op (GUPS)


OPTANE = MachineSpec(fast=TierSpec(80, 100.0), slow=TierSpec(300, 30.0))
TPU_HOST = MachineSpec(
    fast=TierSpec(500, 819.0),
    slow=TierSpec(2500, 50.0),
    page_bytes=2 << 20,
    migration_GBps=25.0,
)


@dataclass
class WorkloadSpec:
    """Hot/warm/cold set access skew, GUPS-style closed-loop tenant."""

    name: str
    n_pages: int
    t_miss: float = 1.0
    threads: int = 2
    # (fraction_of_pages, fraction_of_accesses) per set; remainder uniform
    sets: Tuple[Tuple[float, float], ...] = ()
    value_bytes: int = 64  # per-op payload (16 KB for the KVS workload)

    def __post_init__(self):
        # Reject NaN/negative/degenerate workload parameters at construction
        # (DESIGN.md §7): a poisoned spec must fail loudly HERE, not as a
        # silent NaN deep inside the cost-model fixed point.
        if not (isinstance(self.n_pages, (int, np.integer)) and self.n_pages > 0):
            raise ValueError(f"{self.name}: n_pages must be a positive int, got {self.n_pages!r}")
        if not (np.isfinite(self.t_miss) and 0.0 < self.t_miss <= 1.0):
            raise ValueError(f"{self.name}: t_miss must be finite in (0, 1], got {self.t_miss!r}")
        if not (isinstance(self.threads, (int, np.integer)) and self.threads >= 1):
            raise ValueError(f"{self.name}: threads must be an int >= 1, got {self.threads!r}")
        for i, (fp, fa) in enumerate(self.sets):
            if not (np.isfinite(fp) and 0.0 <= fp <= 1.0 and np.isfinite(fa) and 0.0 <= fa <= 1.0):
                raise ValueError(
                    f"{self.name}: sets[{i}] fractions must be finite in [0, 1], got {(fp, fa)!r}"
                )
        if not (isinstance(self.value_bytes, (int, np.integer)) and self.value_bytes > 0):
            raise ValueError(
                f"{self.name}: value_bytes must be a positive int, got {self.value_bytes!r}"
            )


class TenantSim:
    def __init__(self, spec: WorkloadSpec, page_ids: np.ndarray, rng: np.random.Generator):
        self.spec = spec
        self.page_ids = np.asarray(page_ids)
        self.rng = rng
        # scatter hot/warm sets across the virtual address space: the initial
        # fast-first allocation must not accidentally equal the hot set
        self._perm = rng.permutation(len(page_ids))
        self.probs = self._build_probs(spec, len(page_ids))[self._perm]

    @staticmethod
    def _build_probs(spec: WorkloadSpec, n: int) -> np.ndarray:
        probs = np.zeros(n)
        start = 0
        frac_left = 1.0
        for fp, fa in spec.sets:
            k = max(1, int(round(fp * n)))
            probs[start : start + k] = fa / k
            start += k
            frac_left -= fa
        rest = n - start
        if rest > 0 and frac_left > 0:
            probs[start:] = frac_left / rest
        s = probs.sum()
        return probs / s if s > 0 else np.full(n, 1.0 / n)

    def resize_set(self, set_index: int, new_frac_pages: float):
        """Dynamic hot-set change (Fig. 4 event 5 / Fig. 8 event 2)."""
        sets = list(self.spec.sets)
        fp, fa = sets[set_index]
        sets[set_index] = (new_frac_pages, fa)
        self.spec = dataclasses.replace(self.spec, sets=tuple(sets))
        self.probs = self._build_probs(self.spec, len(self.page_ids))[self._perm]

    def set_skew(self, set_index: int, new_frac_accesses: float):
        """Hotness-skew change: a set's share of accesses moves, its page
        footprint does not (scenario event ``SkewChange``)."""
        sets = list(self.spec.sets)
        fp, fa = sets[set_index]
        sets[set_index] = (fp, new_frac_accesses)
        self.spec = dataclasses.replace(self.spec, sets=tuple(sets))
        self.probs = self._build_probs(self.spec, len(self.page_ids))[self._perm]

    def shift_sets(self):
        """Working-set shift (phase change): re-scatter the skew sets onto a
        fresh permutation of the tenant's pages. Set sizes and access shares
        are unchanged but the policy's learned heat map is instantly stale
        (scenario event ``ShiftWorkingSet``)."""
        self._perm = self.rng.permutation(len(self.page_ids))
        self.probs = self._build_probs(self.spec, len(self.page_ids))[self._perm]

    def pingpong_shift(self):
        """Ping-pong working-set thrash (scenario event ``PingPongShift``):
        toggle between the CURRENT scatter and one fixed alternate. Unlike
        :meth:`shift_sets` the hot set keeps returning to pages the policy
        may still be demoting — the schedule that makes migration cost (and
        the thrashing guard) observable under finite bandwidth."""
        if not hasattr(self, "_pp_perms"):
            self._pp_perms = (self._perm, self.rng.permutation(len(self.page_ids)))
            self._pp_side = 0
        self._pp_side ^= 1
        self._perm = self._pp_perms[self._pp_side]
        self.probs = self._build_probs(self.spec, len(self.page_ids))[self._perm]

    def miss_ratio(self, tier: np.ndarray) -> float:
        t = tier[self.page_ids]
        return float(self.probs[t == TIER_SLOW].sum())


@dataclass
class EpochRecord:
    epoch: int
    throughput: Dict[str, float]  # ops/s per tenant
    fmmr_true: Dict[str, float]
    fmmr_measured: Dict[str, float]
    fast_pages: Dict[str, int]
    p50: Dict[str, float]
    p90: Dict[str, float]
    p99: Dict[str, float]
    migrated_pages: int  # pages COMMITTED this epoch (drains in queue mode)
    stalled: bool
    migration_bytes: float = 0.0  # committed bytes charged to the slow tier
    queue_depth: int = 0  # in-flight migrations after the epoch
    # storm-health flow (queue-mode backends; zeros otherwise): entries
    # enqueued / drained / cancelled during the epoch. Phase-level
    # cancel/drain ratios and ping-pong rates (ResponsivenessStats) sum
    # these per-epoch deltas.
    queue_enqueued: int = 0
    queue_drained: int = 0
    queue_cancelled: int = 0


class ColocationSim:
    """Closed-loop multi-tenant simulation against a placement backend.

    The cost model is vectorized over a tenant axis (prob-matrix [n, P]):
    miss ratios, the 4-iteration latency fixed point and the access-count
    scatter are single array expressions, so simulator overhead stays flat
    as tenants are added. With ``policy_chunk > 1`` and a backend exposing
    ``run_epochs`` (CentralManager), steady-state stretches run k policy
    epochs per ``run_epochs`` call, with one telemetry transfer; chunked
    epochs approximate intermediate miss ratios with the backend's sampled
    FMMR telemetry and do not model migration stalls (chunk boundaries
    always re-measure exactly).
    """

    def __init__(
        self,
        backend,  # CentralManager or a baseline with the same surface
        machine: MachineSpec = OPTANE,
        epoch_seconds: float = 1.0,
        seed: int = 0,
        access_noise: bool = True,
        policy_chunk: int = 1,
    ):
        self.backend = backend
        self.machine = machine
        self.epoch_s = epoch_seconds
        self.rng = np.random.default_rng(seed)
        self.tenants: Dict[str, TenantSim] = {}
        self.handles: Dict[str, int] = {}
        self.history: List[EpochRecord] = []
        self.access_noise = access_noise
        self.policy_chunk = policy_chunk
        self._stall_epochs = 0.0
        # machine failure (scenario MachineFail): a failed sim is frozen —
        # no accesses, no policy ticks; epochs are recorded as down-time
        self.failed = False

    # ----------------------------------------------------------- lifecycle
    def add_tenant(self, spec: WorkloadSpec) -> TenantSim:
        h = self.backend.register(spec.t_miss)
        pages = self.backend.allocate(h, spec.n_pages)
        sim = TenantSim(spec, pages, self.rng)
        self.tenants[spec.name] = sim
        self.handles[spec.name] = h
        return sim

    def remove_tenant(self, name: str):
        h = self.handles.pop(name)
        self.backend.unregister(h)
        del self.tenants[name]

    def fail(self):
        """Machine failure: freeze the backend (scenario ``MachineFail``).
        Nothing mutates while down; :meth:`_record_down` fills the history
        with zero-throughput epochs so the down window is visible in every
        figure. Idempotence is rejected — failing a failed machine is a
        schedule bug."""
        if self.failed:
            raise ValueError("machine is already failed")
        self.failed = True

    def recover(self):
        """Machine recovery (scenario ``MachineRecover``): the backend
        resumes exactly where the failure froze it."""
        if not self.failed:
            raise ValueError("machine is not failed")
        self.failed = False

    def _record_down(self, k: int = 1) -> List[EpochRecord]:
        """Record ``k`` down-time epochs: zero throughput, all-miss FMMR,
        no fast pages, no migrations. Keeps per-epoch histories aligned
        across a fleet when one machine is failed."""
        names = list(self.tenants)
        zero = {nm: 0.0 for nm in names}
        one = {nm: 1.0 for nm in names}
        for _ in range(k):
            self.history.append(EpochRecord(
                epoch=len(self.history),
                throughput=dict(zero),
                fmmr_true=dict(one),
                fmmr_measured=dict(one),
                fast_pages={nm: 0 for nm in names},
                p50=dict(zero), p90=dict(zero), p99=dict(zero),
                migrated_pages=0, stalled=False,
                migration_bytes=0.0, queue_depth=0,
            ))
        return self.history[-k:]

    def set_target(self, name: str, t_miss: float):
        self.backend.set_target(self.handles[name], t_miss)
        self.tenants[name].spec = dataclasses.replace(
            self.tenants[name].spec, t_miss=t_miss
        )

    # ----------------------------------------------------------- cost model
    def _arrays(self):
        """(names, prob_matrix [n,P], page_mask [n,P], threads [n], bpo [n]).

        Rebuilt per epoch (cheap at simulator scale) so hot-set resizes and
        tenant churn are always reflected."""
        names = list(self.tenants)
        P = self.backend.num_pages
        n = len(names)
        M = np.zeros((n, P))
        page_mask = np.zeros((n, P), bool)
        threads = np.empty(n)
        bpo = np.empty(n)
        for i, nm in enumerate(names):
            t = self.tenants[nm]
            M[i, t.page_ids] = t.probs
            page_mask[i, t.page_ids] = True
            threads[i] = t.spec.threads
            bpo[i] = max(t.spec.value_bytes, self.machine.access_bytes)
        return names, M, page_mask, threads, bpo

    def _latencies(
        self, miss: np.ndarray, migration_bytes: float, threads: np.ndarray, bpo: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-point closed-loop: returns (avg_latency_s [n], slow_op_lat_s [n]).

        Per-op latency = tier latency + value transfer at the tier's
        (contention-scaled) bandwidth; bandwidth contention couples tenants
        through the demand sums, so the iteration runs on whole arrays."""
        m = self.machine
        lat_f = m.fast.latency_ns * 1e-9
        lat_s0 = m.slow.latency_ns * 1e-9
        slow_cap = m.slow.bandwidth_GBps * 1e9
        fast_cap = m.fast.bandwidth_GBps * 1e9

        def op_lat(sf=1.0, ss=1.0):
            f = lat_f + bpo / (fast_cap / sf)
            s = lat_s0 * ss + bpo / (slow_cap / ss)
            return f * (1.0 - miss) + s * miss, s

        lat, slow_op = op_lat()
        for _ in range(4):
            tput = threads / lat
            demand_slow = migration_bytes / self.epoch_s + (tput * miss * bpo).sum()
            demand_fast = migration_bytes / self.epoch_s + (tput * (1.0 - miss) * bpo).sum()
            scale_s = max(1.0, demand_slow / slow_cap)
            scale_f = max(1.0, demand_fast / fast_cap)
            lat, slow_op = op_lat(scale_f, scale_s)
        return lat, slow_op

    @staticmethod
    def _mixture_quantile(q: float, miss: float, lat_fast: float, lat_slow: float) -> float:
        return lat_slow if miss > (1.0 - q) else lat_fast

    def _sample_counts(self, M: np.ndarray, ops: np.ndarray) -> np.ndarray:
        """i64[P] access counts reported to the backend this epoch.

        The backend only ever sees the per-page TOTAL across tenants, and a
        sum of independent Poissons is itself Poisson of the summed rate —
        so the noisy path draws ONE [P] sample from the aggregate
        expectation (``ops @ M``) instead of an [n, P] per-tenant draw:
        distributionally identical through every observable, and an
        n-fold cheaper host step on the sweep pipeline's critical path."""
        if self.access_noise:
            drawn = self.rng.poisson(np.maximum(ops @ M, 0.0))
            return drawn.astype(np.int64)
        # noiseless: per-tenant truncation before the sum, exactly as before
        expect = M * ops[:, None]
        return expect.astype(np.int64).sum(axis=0)

    def _record(
        self, names, miss, tput, measured, fast_pages, mig_frac, fast_op, slow_op,
        migrated, stalled, queue_depth=0, queue_flow=(0, 0, 0),
    ) -> EpochRecord:
        """Assemble the per-epoch telemetry dicts from the tenant-axis arrays."""
        quant = {}
        for qq in (0.50, 0.90, 0.99):
            quant[qq] = {
                nm: self._mixture_quantile(qq, miss[i] + mig_frac, fast_op[i], slow_op[i])
                for i, nm in enumerate(names)
            }
        rec = EpochRecord(
            epoch=len(self.history),
            throughput={nm: float(tput[i]) for i, nm in enumerate(names)},
            fmmr_true={nm: float(miss[i]) for i, nm in enumerate(names)},
            fmmr_measured={nm: float(measured[i]) for i, nm in enumerate(names)},
            fast_pages={nm: int(fast_pages[i]) for i, nm in enumerate(names)},
            p50=quant[0.50],
            p90=quant[0.90],
            p99=quant[0.99],
            migrated_pages=int(migrated),
            stalled=stalled,
            migration_bytes=float(migrated) * self.machine.page_bytes,
            queue_depth=int(queue_depth),
            queue_enqueued=int(queue_flow[0]),
            queue_drained=int(queue_flow[1]),
            queue_cancelled=int(queue_flow[2]),
        )
        self.history.append(rec)
        return rec

    def _measured_fmmr(self, names) -> np.ndarray:
        backend = self.backend
        if hasattr(backend, "tenants") and hasattr(backend.tenants, "a_miss"):
            a_miss = _host(backend.tenants.a_miss)  # one batched transfer
            return np.array([a_miss[self.handles[nm]] for nm in names])
        if hasattr(backend, "fmmr_of"):
            return np.array([backend.fmmr_of(self.handles[nm]) for nm in names])
        return np.zeros(len(names))

    # ----------------------------------------------------------- epoch
    def run_epoch(self) -> EpochRecord:
        m = self.machine
        names, M, page_mask, threads, bpo = self._arrays()
        tier = np.asarray(self.backend.tiers())
        miss = (M * (tier == TIER_SLOW)[None, :]).sum(axis=1)

        # migration traffic of the PREVIOUS epoch's plan affects this epoch's
        # latency; simpler: compute after policy and charge within this epoch.
        lat, _slow0 = self._latencies(miss, 0.0, threads, bpo)
        ops = threads / lat * self.epoch_s
        self.backend.record_access(self._sample_counts(M, ops))

        # policy tick (may be stalled by over-requested migration, Fig. 9)
        stalled = self._stall_epochs >= 1.0
        migrated = 0
        queue_depth = 0
        queue_flow = (0, 0, 0)
        if stalled:
            self._stall_epochs -= 1.0
            # the policy thread is frozen but queued migrations are still
            # in flight: report the live depth, not 0
            if hasattr(self.backend, "queue_depth"):
                queue_depth = self.backend.queue_depth()
        else:
            result = self.backend.run_epoch()
            mp = getattr(result, "migrated_pages", None)
            # queue-mode backends report COMMITTED moves (selections may
            # still be in flight); instant backends report the plan
            migrated = (
                mp if mp is not None
                else int(result.plan.num_promote) + int(result.plan.num_demote)
            )
            queue_depth = getattr(result, "queue_depth", 0)
            queue_flow = getattr(result, "queue_flow", (0, 0, 0))
            mig_bytes = migrated * m.page_bytes
            mig_time = mig_bytes / (m.migration_GBps * 1e9)
            # a backend whose drain is ALREADY paced by a finite bandwidth
            # models its own DMA contention; everyone else (instant apply,
            # or a queue with unlimited bandwidth dumping its backlog) is
            # subject to the over-requested-migration stall (Fig. 9)
            paced = getattr(self.backend, "migration_bounded", False)
            if mig_time > self.epoch_s and not paced:
                self._stall_epochs += mig_time / self.epoch_s - 1.0

        # recompute latency including migration interference
        mig_bytes = migrated * m.page_bytes
        lat, slow_op = self._latencies(miss, mig_bytes, threads, bpo)
        fast_op = m.fast.latency_ns * 1e-9 + bpo / (m.fast.bandwidth_GBps * 1e9)
        # write-protect stall term: fraction of accesses landing on in-flight
        # pages pay the slow-tier copy latency
        mig_frac = min(mig_bytes / max(m.page_bytes, 1) / max(self.backend.num_pages, 1), 1.0)

        tput = threads / lat
        measured = self._measured_fmmr(names)
        tier = np.asarray(self.backend.tiers())
        owner = np.asarray(self.backend.owners())
        fast_pages = (page_mask & (owner >= 0)[None, :] & (tier == TIER_FAST)[None, :]).sum(axis=1)
        return self._record(
            names, miss, tput, measured, fast_pages, mig_frac, fast_op, slow_op,
            migrated, stalled, queue_depth=queue_depth, queue_flow=queue_flow,
        )

    def _chunk_prepare(self, arrays=None, tier=None):
        """(counts[P], ctx) for a chunked stretch: freeze the access
        distribution at the chunk entry and draw one epoch's worth of
        access counts (replayed every epoch by the scan). ``ctx`` carries
        the frozen cost-model arrays for :meth:`_chunk_record`.

        ``arrays`` (a prior :meth:`_arrays` result) and ``tier`` (the
        chunk-entry placement) let the pipelined sweep driver reuse the
        tenant matrices across the chunks of an event-free stretch and feed
        the placement from one stacked fleet transfer — same values either
        way, so the drawn counts (and the RNG stream) are bit-identical to
        the self-measuring path."""
        names, M, page_mask, threads, bpo = arrays if arrays is not None else self._arrays()
        if tier is None:
            tier = np.asarray(self.backend.tiers())
        miss0 = (M * (tier == TIER_SLOW)[None, :]).sum(axis=1)
        lat, _ = self._latencies(miss0, 0.0, threads, bpo)
        ops = threads / lat * self.epoch_s
        return self._sample_counts(M, ops), (names, M, threads, bpo)

    def _chunk_record(self, res, k: int, ctx, tier_end=None) -> List[EpochRecord]:
        """Fold a ``MultiEpochResult`` for a chunk prepared by
        :meth:`_chunk_prepare` into the epoch history (one telemetry
        snapshot for the whole chunk). ``tier_end`` is the post-chunk
        placement; passing it (captured at the NEXT chunk's prepare) lets
        the pipelined driver record this chunk while the next one is
        already executing on device."""
        m = self.machine
        names, M, threads, bpo = ctx

        handles = [self.handles[nm] for nm in names]
        fmmr_now = _host(res.stats.fmmr_now)[:, handles]  # [k, n]
        # stats.fast_pages is the holding BEFORE that epoch's migration; add
        # the epoch's own moves so chunked records match the single-step
        # path's post-migration read (ownership is static within a chunk).
        # In queue mode selections are not commits: the next epoch's holdings
        # already reflect the bounded drain, so no adjustment is sound there.
        if getattr(res.stats, "queue", None) is not None:
            fastp = _host(res.stats.fast_pages)[:, handles]
        else:
            fastp = (
                _host(res.stats.fast_pages)
                + _host(res.stats.promoted)
                - _host(res.stats.demoted)
            )[:, handles]
        migrated = res.migrated_per_epoch
        depth = res.queue_depth_per_epoch
        flows = (
            res.queue_flow_per_epoch
            if hasattr(res, "queue_flow_per_epoch")
            else np.zeros((k, 3), np.int64)
        )
        measured_k = _host(res.stats.fmmr_ewma)[:, handles]
        if tier_end is None:
            tier_end = np.asarray(self.backend.tiers())
        miss_end = (M * (tier_end == TIER_SLOW)[None, :]).sum(axis=1)
        fast_op = m.fast.latency_ns * 1e-9 + bpo / (m.fast.bandwidth_GBps * 1e9)
        for i in range(k):
            miss = miss_end if i == k - 1 else fmmr_now[i]
            mig_bytes = migrated[i] * m.page_bytes
            lat, slow_op = self._latencies(miss, mig_bytes, threads, bpo)
            mig_frac = min(mig_bytes / max(m.page_bytes, 1) / max(self.backend.num_pages, 1), 1.0)
            self._record(
                names, miss, threads / lat, measured_k[i], fastp[i], mig_frac,
                fast_op, slow_op, migrated[i], stalled=False, queue_depth=depth[i],
                queue_flow=flows[i],
            )
        return self.history[-k:]

    def run_chunk(self, k: int) -> List[EpochRecord]:
        """Run k epochs through the backend's ``run_epochs``.

        The access distribution is frozen at the chunk entry (steady-state
        assumption); intermediate miss ratios come from the backend's sampled
        FMMR telemetry, the final epoch re-measures placement exactly.
        Migration stalls are not modeled inside a chunk.
        """
        counts, ctx = self._chunk_prepare()
        res = self.backend.run_epochs(k, counts=counts)
        return self._chunk_record(res, k, ctx)

    def run(
        self,
        n_epochs: int,
        events: Optional[Dict[int, Callable[["ColocationSim"], None]]] = None,
    ) -> List[EpochRecord]:
        events = events or {}
        end = len(self.history) + n_epochs
        while len(self.history) < end:
            cur = len(self.history)
            if cur in events:
                events[cur](self)
            if self.failed:
                self._record_down(1)
                continue
            chunkable = (
                self.policy_chunk > 1
                and self.tenants
                and hasattr(self.backend, "run_epochs")
                and self._stall_epochs < 1.0
            )
            if chunkable:
                horizon = min([e for e in events if e > cur], default=end)
                k = min(self.policy_chunk, horizon - cur, end - cur)
            else:
                k = 1
            if k > 1:
                self.run_chunk(k)
            else:
                self.run_epoch()
        return self.history

    def run_scenario(self, scenario, on_event=None):
        """Execute a declarative ``core.scenario.Scenario`` against this
        sim's backend; returns a ``ScenarioResult`` with per-phase
        aggregates. (Thin delegate — the engine lives in core/scenario.py.)
        """
        from repro_torch.core.scenario import run_scenario

        return run_scenario(self, scenario, on_event=on_event)
