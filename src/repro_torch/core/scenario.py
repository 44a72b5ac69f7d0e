"""Declarative dynamic-colocation scenarios (paper §5, Figs. 7-9).

The paper's headline results come from *dynamic* workloads — tenants
arriving, departing and shifting working sets while competitors hold static
partitions or thrash. A :class:`Scenario` is a declarative script of timed
events that :func:`run_scenario` executes against any placement backend
driven by ``ColocationSim`` (MaxMem's ``CentralManager`` or any baseline
from ``core.baselines``), so all policies face byte-identical workload
timelines.

Event semantics (all events fire *before* the epoch they are stamped with,
in the order they appear in ``Scenario.events``):

  ``Arrive(epoch, spec)``       register + allocate a tenant (fast-first)
  ``Depart(epoch, name)``       free all pages + unregister the tenant
  ``ResizeWorkingSet(...)``     grow/shrink a skew set's page fraction
                                (paper Fig. 4 event 5 / Fig. 8 event 2)
  ``ShiftWorkingSet(...)``      re-scatter the skew sets onto fresh pages —
                                a phase change: the learned heat map is
                                instantly stale (TPP-style thrash)
  ``SkewChange(...)``           change a set's share of accesses (hotness
                                skew), page footprint unchanged
  ``Retarget(...)``             dynamic QoS t_miss update (paper §3.3)
  ``PingPongShift(...)``        toggle the working set between two fixed
                                scatters — the thrash schedule that makes
                                bounded migration bandwidth observable
  ``SetMigrationBandwidth(...)`` bound the backend's migration drain
                                (pages/epoch; None = unlimited); backends
                                without a data plane clamp their per-epoch
                                migration budget instead

Fault events (DESIGN.md §7) share the same surface; each takes an optional
``machine`` index that the reference's fleet sweep uses to target one
machine (None = all), while single-sim runs apply it to the whole backend:

  ``MachineFail(...)``          drop a machine: its fleet row is parked and
                                runs inert; epochs record as down-time
  ``MachineRecover(...)``       restore the parked state bit-identically
  ``BandwidthDegrade(...)``     scale migration bandwidth RELATIVE to the
                                configured value (degraded DMA engine);
                                factor=1.0 restores
  ``DataPlaneError(...)``       attach a seeded ``FaultInjector`` to the
                                page pool: moves fail probabilistically
                                with bounded retry; no-op without a pool
  ``TelemetryCorrupt(...)``     poison one cell of the policy state — the
                                corruption the invariant sentinel catches

Epoch boundaries at which any event fires split the timeline into *phases*;
:class:`ScenarioResult` aggregates per-tenant throughput/p99/FMMR per phase
(plus migration bytes and mean queue depth), which is exactly the shape of
the paper's Fig. 7-9 curves.

A copy of the JAX package's ``core/scenario.py`` up to ``run_scenario``;
host numpy, so the same timeline drives the reference and the port, and the
port's manager wherever it lives. The fleet sweep (``SweepPoint``,
``ScenarioSweep``, ``SweepResult``, ``run_sweep``) drives the fleet manager
and is not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.simulator import OPTANE, ColocationSim, EpochRecord, WorkloadSpec


# ------------------------------------------------------------------ events
@dataclass(frozen=True)
class Arrive:
    epoch: int
    spec: WorkloadSpec

    def apply(self, sim: ColocationSim) -> None:
        sim.add_tenant(self.spec)

    def label(self) -> str:
        return f"+{self.spec.name}"


@dataclass(frozen=True)
class Depart:
    epoch: int
    name: str

    def apply(self, sim: ColocationSim) -> None:
        sim.remove_tenant(self.name)

    def label(self) -> str:
        return f"-{self.name}"


@dataclass(frozen=True)
class ResizeWorkingSet:
    epoch: int
    name: str
    set_index: int
    frac_pages: float

    def validate(self) -> None:
        if not (np.isfinite(self.frac_pages) and 0.0 <= self.frac_pages <= 1.0):
            raise ValueError(
                f"ResizeWorkingSet frac_pages must be finite in [0, 1], "
                f"got {self.frac_pages!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        sim.tenants[self.name].resize_set(self.set_index, self.frac_pages)

    def label(self) -> str:
        return f"{self.name}.set{self.set_index}~{self.frac_pages:g}p"


@dataclass(frozen=True)
class ShiftWorkingSet:
    epoch: int
    name: str

    def apply(self, sim: ColocationSim) -> None:
        sim.tenants[self.name].shift_sets()

    def label(self) -> str:
        return f"{self.name}.shift"


@dataclass(frozen=True)
class SkewChange:
    epoch: int
    name: str
    set_index: int
    frac_accesses: float

    def validate(self) -> None:
        if not (np.isfinite(self.frac_accesses) and 0.0 <= self.frac_accesses <= 1.0):
            raise ValueError(
                f"SkewChange frac_accesses must be finite in [0, 1], "
                f"got {self.frac_accesses!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        sim.tenants[self.name].set_skew(self.set_index, self.frac_accesses)

    def label(self) -> str:
        return f"{self.name}.set{self.set_index}~{self.frac_accesses:g}a"


@dataclass(frozen=True)
class Retarget:
    epoch: int
    name: str
    t_miss: float

    def validate(self) -> None:
        if not (np.isfinite(self.t_miss) and 0.0 < self.t_miss <= 1.0):
            raise ValueError(
                f"Retarget t_miss must be finite in (0, 1], got {self.t_miss!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        sim.set_target(self.name, self.t_miss)

    def label(self) -> str:
        return f"{self.name}.t={self.t_miss:g}"


@dataclass(frozen=True)
class PingPongShift:
    epoch: int
    name: str

    def apply(self, sim: ColocationSim) -> None:
        sim.tenants[self.name].pingpong_shift()

    def label(self) -> str:
        return f"{self.name}.pingpong"


@dataclass(frozen=True)
class SetMigrationBandwidth:
    epoch: int
    pages_per_epoch: Optional[int]  # None = unlimited

    def validate(self) -> None:
        bw = self.pages_per_epoch
        if bw is not None and (not np.isfinite(bw) or int(bw) < 0):
            raise ValueError(
                f"SetMigrationBandwidth pages_per_epoch must be None or a "
                f"non-negative int, got {bw!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        backend = sim.backend
        if hasattr(backend, "set_migration_bandwidth"):
            backend.set_migration_bandwidth(self.pages_per_epoch)
            return
        if not hasattr(backend, "migration_budget"):
            # hardware-managed placement (TwoLM): every access IS the
            # insertion path — there is no migration engine to throttle
            return
        # instant-apply baselines (HeMem, AutoNUMA): their per-epoch budget
        # IS the bandwidth. Stash the configured value on first clamp so a
        # later None event restores it rather than leaving the clamp behind.
        if not hasattr(backend, "_unclamped_migration_budget"):
            backend._unclamped_migration_budget = backend.migration_budget
        if self.pages_per_epoch is None:
            backend.migration_budget = backend._unclamped_migration_budget
        else:
            backend.migration_budget = int(self.pages_per_epoch)

    def label(self) -> str:
        bw = "inf" if self.pages_per_epoch is None else self.pages_per_epoch
        return f"bw={bw}"


# ----------------------------------------------------------- fault events
def _machine_tag(machine: Optional[int]) -> str:
    return "*" if machine is None else str(machine)


@dataclass(frozen=True)
class MachineFail:
    """Drop a machine mid-run (DESIGN.md §7).

    In a fleet sweep the targeted machine's ``PolicyState`` is parked
    host-side and the row runs inert until :class:`MachineRecover`; its
    epochs record as down-time (zero throughput, all-miss). On a single sim
    the whole backend freezes (``ColocationSim.fail``)."""

    epoch: int
    machine: Optional[int] = None  # sweep machine index; None = all

    def apply(self, sim: ColocationSim) -> None:
        sim.fail()

    def label(self) -> str:
        return f"fail[{_machine_tag(self.machine)}]"


@dataclass(frozen=True)
class MachineRecover:
    """Restore a failed machine's parked state bit-identically; its PRNG
    stream and migration queue resume exactly where the failure froze
    them."""

    epoch: int
    machine: Optional[int] = None

    def apply(self, sim: ColocationSim) -> None:
        sim.recover()

    def label(self) -> str:
        return f"recover[{_machine_tag(self.machine)}]"


@dataclass(frozen=True)
class BandwidthDegrade:
    """Scale migration bandwidth RELATIVE to the configured value (a
    degraded DMA engine / interconnect), unlike the absolute
    :class:`SetMigrationBandwidth`. ``factor=1.0`` restores full bandwidth.
    A queue-mode manager running unlimited is first pinned to its migration
    budget (the engine's nominal peak) so there is a finite value to scale;
    hardware-managed baselines (TwoLM) have no migration engine and no-op."""

    epoch: int
    factor: float
    machine: Optional[int] = None

    def validate(self) -> None:
        if not (np.isfinite(self.factor) and 0.0 < self.factor <= 1.0):
            raise ValueError(
                f"BandwidthDegrade factor must be finite in (0, 1], "
                f"got {self.factor!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        backend = sim.backend
        if hasattr(backend, "set_migration_bandwidth") and getattr(backend, "queue_size", 0) > 0:
            # queue-mode manager: scale the drain bandwidth
            if not hasattr(backend, "_undegraded_bandwidth"):
                bw = int(backend.params.migration_bandwidth)
                backend._undegraded_bandwidth = None if bw < 0 else bw
            orig = backend._undegraded_bandwidth
            if self.factor >= 1.0:
                backend.set_migration_bandwidth(orig)
            else:
                nominal = int(backend.params.migration_budget) if orig is None else orig
                backend.set_migration_bandwidth(max(1, int(nominal * self.factor)))
            return
        if hasattr(backend, "migration_budget"):
            # instant-apply baselines: the per-epoch budget IS the bandwidth.
            # budget None = unlimited (AutoNUMA's default) — no finite
            # engine rate exists to scale, so degradation is a no-op there
            if not hasattr(backend, "_undegraded_migration_budget"):
                backend._undegraded_migration_budget = backend.migration_budget
            orig = backend._undegraded_migration_budget
            if orig is not None:
                backend.migration_budget = (
                    orig if self.factor >= 1.0 else max(1, int(orig * self.factor))
                )
            return
        if hasattr(backend, "params") and hasattr(backend.params, "migration_budget"):
            # instant-apply CentralManager: scale the budget
            if not hasattr(backend, "_undegraded_migration_budget"):
                backend._undegraded_migration_budget = int(backend.params.migration_budget)
            orig = backend._undegraded_migration_budget
            new = orig if self.factor >= 1.0 else max(1, int(orig * self.factor))
            backend.params = backend.params._replace(migration_budget=int(new))
        # hardware-managed placement (TwoLM): nothing to degrade

    def label(self) -> str:
        return f"bw*{self.factor:g}[{_machine_tag(self.machine)}]"


@dataclass(frozen=True)
class DataPlaneError:
    """Attach a seeded ``core.faults.FaultInjector`` to the backend's page
    pool: each DMA page move fails with probability ``rate``, retried with
    exponential backoff up to ``max_retries`` times; abandoned moves stay in
    their source tier (commit-on-completion fallback — degraded, never
    corrupt). ``rate=0`` detaches. No-op on backends without a pool."""

    epoch: int
    rate: float
    max_retries: int = 3
    seed: int = 0
    machine: Optional[int] = None

    def validate(self) -> None:
        if not (np.isfinite(self.rate) and 0.0 <= self.rate <= 1.0):
            raise ValueError(
                f"DataPlaneError rate must be finite in [0, 1], got {self.rate!r}"
            )
        if self.max_retries < 0:
            raise ValueError(
                f"DataPlaneError max_retries must be >= 0, got {self.max_retries!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        backend = sim.backend
        if getattr(backend, "pool", None) is None or not hasattr(backend, "set_fault_injector"):
            return  # no page data plane — nothing whose move can fail
        if self.rate <= 0.0:
            backend.set_fault_injector(None)
        else:
            from repro_torch.core.faults import FaultInjector

            backend.set_fault_injector(FaultInjector(
                move_fail_rate=self.rate, max_retries=self.max_retries,
                seed=self.seed,
            ))

    def label(self) -> str:
        return f"dma-err={self.rate:g}[{_machine_tag(self.machine)}]"


@dataclass(frozen=True)
class TelemetryCorrupt:
    """Poison one cell of the policy state (``kind='tier'`` unplaces an
    owned page, ``'nan'`` drops NaN into an FMMR EWMA) — exactly the
    corruptions the invariant sentinel exists to catch. Transient: a sweep
    restoring from a checkpoint does NOT replay an already-fired poison
    (else detect -> restore would loop forever)."""

    epoch: int
    kind: str = "tier"
    machine: Optional[int] = None

    transient = True  # class attr: one-shot, skipped on restore replay

    def validate(self) -> None:
        if self.kind not in ("tier", "nan"):
            raise ValueError(
                f"TelemetryCorrupt kind must be 'tier' or 'nan', got {self.kind!r}"
            )

    def apply(self, sim: ColocationSim) -> None:
        backend = sim.backend
        if hasattr(backend, "poison_telemetry"):
            backend.poison_telemetry(self.kind)

    def label(self) -> str:
        return f"poison:{self.kind}[{_machine_tag(self.machine)}]"


ScenarioEvent = Union[Arrive, Depart, ResizeWorkingSet, ShiftWorkingSet,
                      SkewChange, Retarget, PingPongShift, SetMigrationBandwidth,
                      MachineFail, MachineRecover, BandwidthDegrade,
                      DataPlaneError, TelemetryCorrupt]


def _check_window(kind: str, start: int, end: int, period: int) -> None:
    """Construction-time guards shared by the schedule generators: a
    degenerate window or period silently yields an empty/endless schedule
    downstream, so it fails HERE with a clear message (PR 6 validation
    contract)."""
    if not (np.isfinite(period) and int(period) > 0):
        raise ValueError(f"{kind} period must be a positive int, got {period!r}")
    if not (np.isfinite(start) and int(start) >= 0):
        raise ValueError(f"{kind} start must be >= 0, got {start!r}")
    if not (np.isfinite(end) and int(end) > int(start)):
        raise ValueError(
            f"{kind} window is empty: end ({end!r}) must be > start ({start!r})"
        )


def pingpong_schedule(name: str, start: int, end: int, period: int) -> Tuple[PingPongShift, ...]:
    """A ping-pong thrash schedule: flip ``name``'s working set every
    ``period`` epochs in ``[start, end)`` — each flip returns the hot set to
    pages the policy may still be draining, so queued demotions keep
    re-heating (the thrashing-guard regime)."""
    _check_window("pingpong_schedule", start, end, period)
    return tuple(PingPongShift(e, name) for e in range(start, end, period))


def diurnal_schedule(
    name: str,
    start: int,
    end: int,
    period: int,
    lo: float = 0.2,
    hi: float = 0.9,
    set_index: int = 0,
) -> Tuple[SkewChange, ...]:
    """Diurnal traffic generator: oscillate ``name``'s hot-set access share
    sinusoidally between ``lo`` and ``hi`` with the given ``period``
    (sampled every quarter period) — the day/night load swing that slowly
    invalidates a learned heat map instead of snapping it (contrast
    :func:`pingpong_schedule`)."""
    _check_window("diurnal_schedule", start, end, period)
    for label, v in (("lo", lo), ("hi", hi)):
        if not (np.isfinite(v) and 0.0 <= v <= 1.0):
            raise ValueError(
                f"diurnal_schedule {label} must be finite in [0, 1], got {v!r}"
            )
    if lo > hi:
        raise ValueError(f"diurnal_schedule needs lo <= hi, got {lo!r} > {hi!r}")
    mid, amp = (hi + lo) / 2.0, (hi - lo) / 2.0
    step = max(int(period) // 4, 1)
    return tuple(
        SkewChange(
            e, name, set_index,
            float(mid + amp * np.sin(2.0 * np.pi * (e - start) / period)),
        )
        for e in range(start, end, step)
    )


# ---------------------------------------------------------------- scenario
@dataclass(frozen=True)
class Scenario:
    """A named, validated script of timed events over ``n_epochs``."""

    name: str
    n_epochs: int
    events: Tuple[ScenarioEvent, ...] = ()
    description: str = ""

    def __post_init__(self):
        assert self.n_epochs > 0, "scenario must run at least one epoch"
        for ev in self.events:
            assert 0 <= ev.epoch < self.n_epochs, (
                f"event {ev} outside [0, {self.n_epochs})"
            )
            # events with value constraints self-validate at construction
            # (NaN/negative rates, bandwidths, working-set fractions fail
            # HERE with a clear message, not as silent NaN downstream)
            validate = getattr(ev, "validate", None)
            if validate is not None:
                validate()

    def events_at(self, epoch: int) -> List[ScenarioEvent]:
        return [ev for ev in self.events if ev.epoch == epoch]

    def phase_boundaries(self) -> List[int]:
        """Sorted epoch indices that open a phase (0 plus event epochs)."""
        return sorted({0, *(ev.epoch for ev in self.events)})

    def phase_spans(self) -> List[Tuple[int, int, str]]:
        """(start, end, label) per phase; label names the opening events."""
        bounds = self.phase_boundaries() + [self.n_epochs]
        spans = []
        for start, end in zip(bounds[:-1], bounds[1:]):
            if start == end:
                continue
            evs = self.events_at(start)
            label = ",".join(ev.label() for ev in evs) if evs else "start"
            spans.append((start, end, label))
        return spans


def scale_colocation(
    n_pages: int,
    n_tenants: int,
    n_epochs: int,
    churn: float = 0.25,
) -> Scenario:
    """Geometry-parameterized colocation scenario for the scaling sweep.

    Unlike the hand-tuned figure scenarios, this builder takes the
    (pages, tenants) geometry as free axes so the scale bench and the
    churn tests can script a manager-grade run at ANY grid point. Core
    tenants (all but a ``churn`` fraction) arrive at epoch 0; the churn
    cohort arrives in a batch at n_epochs/4 and departs at 3·n_epochs/4 —
    two mass register/free/unregister waves that exercise the incremental
    ``OwnerSegments`` splice with many tenants mutating at once.

    Footprints total 3/4 of ``n_pages`` at peak concurrency, leaving
    allocation headroom; odd-index tenants are latency-sensitive (skewed
    hot set, reachable t_miss), even-index are best-effort uniform — so
    the reallocation loop has real FMMR gradients to act on at every T.
    """
    assert n_tenants >= 2, "scale scenario needs at least two tenants"
    assert n_epochs >= 4, "scale scenario needs at least four epochs"
    assert 0.0 <= churn < 1.0, f"churn fraction must be in [0, 1), got {churn}"
    n_churn = int(round(churn * n_tenants))
    n_core = n_tenants - n_churn
    fp = (3 * n_pages) // (4 * n_tenants)
    assert fp >= 8, (
        f"geometry too thin: {n_pages} pages / {n_tenants} tenants "
        f"leaves {fp} pages per tenant (need >= 8)"
    )

    def _spec(i: int) -> WorkloadSpec:
        if i % 2 == 1:  # latency-sensitive: skewed, reachable target
            return WorkloadSpec(f"t{i:03d}", n_pages=fp, t_miss=0.3,
                                threads=2, sets=((0.2, 0.8),))
        return WorkloadSpec(f"t{i:03d}", n_pages=fp, t_miss=1.0, threads=2)

    arrive_at = max(1, n_epochs // 4)
    depart_at = max(arrive_at + 1, (3 * n_epochs) // 4)
    events: List[ScenarioEvent] = [Arrive(0, _spec(i)) for i in range(n_core)]
    for j in range(n_churn):
        i = n_core + j
        events.append(Arrive(arrive_at, _spec(i)))
        events.append(Depart(depart_at, f"t{i:03d}"))
    return Scenario(
        name=f"scale_{n_pages // 1024}k_x{n_tenants}",
        n_epochs=n_epochs,
        events=tuple(events),
        description="geometry-parameterized colocation with batch tenant churn",
    )


# ------------------------------------------------- adversarial storm suite
#
# Jenga-class storms (PAPERS.md): schedules engineered to provoke
# promotion/demotion storms rather than model a realistic mix. Each
# builder composes the validated event vocabulary above, lives in core so
# the tuner family and the differential tests need only ``src`` on the
# path (the skewshift precedent), and uses the repo-wide geometry
# convention fast = P/8 unless told otherwise.

def _storm_geometry(n_pages: int, n_epochs: int, fast_capacity: Optional[int]) -> int:
    if n_epochs < 8:
        raise ValueError(f"storm scenarios need n_epochs >= 8, got {n_epochs}")
    fast = n_pages // 8 if fast_capacity is None else int(fast_capacity)
    if fast < 16:
        raise ValueError(
            f"storm geometry too thin: fast tier of {fast} pages (need >= 16)"
        )
    return fast


def boundary_straddle_scenario(
    n_pages: int,
    n_epochs: int,
    fast_capacity: Optional[int] = None,
    epsilon: float = 0.08,
    period: Optional[int] = None,
) -> Scenario:
    """Working set sized at ``fast_capacity ± epsilon``: the ``edge``
    tenant's hot set oscillates between just-fits and just-overflows, so
    every flip re-decides which boundary pages deserve the fast tier —
    the canonical promotion/demotion storm (Jenga §1)."""
    fast = _storm_geometry(n_pages, n_epochs, fast_capacity)
    if not (np.isfinite(epsilon) and 0.0 < epsilon < 0.5):
        raise ValueError(
            f"boundary_straddle epsilon must be finite in (0, 0.5), got {epsilon!r}"
        )
    footprint = 2 * fast
    lo_frac = (1.0 - epsilon) / 2.0  # hot pages = fast * (1 - epsilon)
    hi_frac = (1.0 + epsilon) / 2.0  # hot pages = fast * (1 + epsilon)
    per = max(2, n_epochs // 8) if period is None else period
    _check_window("boundary_straddle", n_epochs // 4, (3 * n_epochs) // 4, per)
    flips = tuple(
        ResizeWorkingSet(e, "edge", 0, hi_frac if i % 2 == 0 else lo_frac)
        for i, e in enumerate(range(n_epochs // 4, (3 * n_epochs) // 4, per))
    )
    return Scenario(
        name=f"storm_boundary_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            Arrive(0, WorkloadSpec(
                "edge", footprint, t_miss=0.3, threads=4,
                sets=((lo_frac, 0.9),),
            )),
            Arrive(0, WorkloadSpec(
                "kvs", n_pages // 8, t_miss=0.3, threads=4,
                sets=((0.2, 0.85),),
            )),
            Arrive(0, WorkloadSpec("gups", n_pages // 4, threads=6)),
            *flips,
        ),
        description="hot set straddles fast capacity (fast*(1 +- epsilon))",
    )


def correlated_flips_scenario(
    n_pages: int,
    n_epochs: int,
    fast_capacity: Optional[int] = None,
    n_flippers: int = 3,
    period: Optional[int] = None,
) -> Scenario:
    """Correlated multi-tenant phase flips: every flipper ping-pongs its
    working set at the SAME epochs, so the migration queue absorbs all
    tenants' stale-heat churn at once instead of amortizing it."""
    _storm_geometry(n_pages, n_epochs, fast_capacity)
    if n_flippers < 2:
        raise ValueError(f"correlated_flips needs >= 2 flippers, got {n_flippers}")
    per = max(2, n_epochs // 8) if period is None else period
    fp = (3 * n_pages) // (8 * n_flippers)
    flips: List[ScenarioEvent] = []
    arrivals: List[ScenarioEvent] = []
    for i in range(n_flippers):
        nm = f"flip{i}"
        arrivals.append(Arrive(0, WorkloadSpec(
            nm, fp, t_miss=0.3, threads=4, sets=((0.25, 0.85),),
        )))
        flips.extend(pingpong_schedule(nm, n_epochs // 4, (3 * n_epochs) // 4, per))
    return Scenario(
        name=f"storm_correlated_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            *arrivals,
            Arrive(0, WorkloadSpec("gups", n_pages // 4, threads=6)),
            *flips,
        ),
        description=f"{n_flippers} tenants ping-pong in lockstep",
    )


def burst_arrivals_scenario(
    n_pages: int,
    n_epochs: int,
    fast_capacity: Optional[int] = None,
    burst: int = 3,
) -> Scenario:
    """Open-loop burst arrivals: cohorts of tenants register and allocate
    in one epoch regardless of system state (open-loop: the schedule never
    waits for the queue to drain), each cohort departing as the next
    lands — allocation-reserve pressure plus mass ownership churn."""
    _storm_geometry(n_pages, n_epochs, fast_capacity)
    if burst < 1:
        raise ValueError(f"burst_arrivals burst must be >= 1, got {burst}")
    fp = n_pages // 16
    b1, b2, b3 = n_epochs // 4, n_epochs // 2, (3 * n_epochs) // 4
    events: List[ScenarioEvent] = [
        Arrive(0, WorkloadSpec(
            "kvs", n_pages // 4, t_miss=0.3, threads=4, sets=((0.2, 0.85),),
        )),
        Arrive(0, WorkloadSpec("gups", n_pages // 8, threads=6)),
    ]
    for j in range(burst):
        events.append(Arrive(b1, WorkloadSpec(f"burst0_{j}", fp, threads=2)))
    for j in range(burst):  # cohort 0 leaves exactly as cohort 1 lands
        events.append(Depart(b2, f"burst0_{j}"))
        events.append(Arrive(b2, WorkloadSpec(f"burst1_{j}", fp, threads=2)))
    for j in range(burst):
        events.append(Depart(b3, f"burst1_{j}"))
    return Scenario(
        name=f"storm_burst_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=tuple(events),
        description=f"open-loop arrival bursts of {burst} tenants",
    )


def diurnal_scenario(
    n_pages: int,
    n_epochs: int,
    fast_capacity: Optional[int] = None,
    lo: float = 0.3,
    hi: float = 0.95,
) -> Scenario:
    """Diurnal load swing: the ``web`` tenant's hot-set share follows a
    sine between ``lo`` and ``hi`` (:func:`diurnal_schedule`) while a
    batch tenant soaks the slack — the slow phase change that rewards a
    policy for NOT chasing every sample."""
    _storm_geometry(n_pages, n_epochs, fast_capacity)
    swings = diurnal_schedule(
        "web", 1, n_epochs, max(n_epochs // 2, 4), lo=lo, hi=hi
    )
    return Scenario(
        name=f"storm_diurnal_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            Arrive(0, WorkloadSpec(
                "web", (3 * n_pages) // 8, t_miss=0.3, threads=4,
                sets=((0.15, lo),),
            )),
            Arrive(0, WorkloadSpec("gups", n_pages // 4, threads=6)),
            *swings,
        ),
        description="sinusoidal hot-share swing (day/night traffic)",
    )


STORM_FAMILIES = ("boundary", "correlated", "burst", "diurnal")

_STORM_MAKERS = {
    "boundary": boundary_straddle_scenario,
    "correlated": correlated_flips_scenario,
    "burst": burst_arrivals_scenario,
    "diurnal": diurnal_scenario,
}


def storm_scenario(family: str, n_pages: int, n_epochs: int, **kw) -> Scenario:
    """Build one storm family by name (``STORM_FAMILIES``)."""
    if family not in _STORM_MAKERS:
        raise KeyError(
            f"unknown storm family {family!r}; choose from {STORM_FAMILIES}"
        )
    return _STORM_MAKERS[family](n_pages, n_epochs, **kw)


def adversarial_scenario(
    n_pages: int,
    n_epochs: int,
    fast_capacity: Optional[int] = None,
    epsilon: float = 0.08,
) -> Scenario:
    """The composite storm the ``adversarial`` tuner family trains on: a
    boundary-straddling working set whose resize flips are phase-locked
    with a ping-pong flipper — boundary pressure and correlated stale heat
    hitting the queue in the same epochs."""
    base = boundary_straddle_scenario(
        n_pages, n_epochs, fast_capacity=fast_capacity, epsilon=epsilon
    )
    per = max(2, n_epochs // 8)
    flip_spec = Arrive(0, WorkloadSpec(
        "flip", n_pages // 8, t_miss=0.3, threads=4, sets=((0.25, 0.85),),
    ))
    # replace the plain kvs tenant with the flipper, keeping total footprint
    events = tuple(
        ev for ev in base.events
        if not (isinstance(ev, Arrive) and ev.spec.name == "kvs")
    )
    return Scenario(
        name=f"storm_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            flip_spec,
            *events,
            *pingpong_schedule("flip", n_epochs // 4, (3 * n_epochs) // 4, per),
        ),
        description="boundary straddle + phase-locked ping-pong composite",
    )


# ------------------------------------------------------------------ result
@dataclass
class PhaseStats:
    """Per-phase aggregates (the paper-figure observables)."""

    label: str
    start: int
    end: int
    throughput: Dict[str, float]  # mean ops/s per tenant while present
    p99: Dict[str, float]  # mean p99 seconds per tenant
    fmmr: Dict[str, float]  # mean true FMMR per tenant
    agg_throughput: float  # mean over epochs of sum-over-tenants ops/s
    mean_p99: float  # mean over (epoch, tenant) p99 seconds
    migrated_pages: int
    migration_bytes: float = 0.0  # committed migration traffic in the phase
    mean_queue_depth: float = 0.0  # mean in-flight migrations per epoch
    max_queue_depth: int = 0

    def to_jsonable(self) -> dict:
        return {
            "label": self.label, "start": self.start, "end": self.end,
            "agg_throughput": self.agg_throughput,
            "mean_p99_us": self.mean_p99 * 1e6,
            "throughput": self.throughput,
            "p99_us": {k: v * 1e6 for k, v in self.p99.items()},
            "fmmr": self.fmmr,
            "migrated_pages": self.migrated_pages,
            "migration_bytes": self.migration_bytes,
            "mean_queue_depth": self.mean_queue_depth,
            "max_queue_depth": self.max_queue_depth,
        }


@dataclass
class ScenarioResult:
    scenario: Scenario
    history: List[EpochRecord]
    phases: List[PhaseStats] = field(default_factory=list)

    @property
    def steady_state(self) -> PhaseStats:
        """The final phase — the paper's end-of-run comparison window."""
        return self.phases[-1]

    def to_jsonable(self) -> dict:
        return {
            "scenario": self.scenario.name,
            "n_epochs": self.scenario.n_epochs,
            "phases": [p.to_jsonable() for p in self.phases],
        }


def _phase_stats(history: List[EpochRecord], start: int, end: int, label: str) -> PhaseStats:
    recs = history[start:end]
    names = sorted({nm for r in recs for nm in r.throughput})
    tput, p99, fmmr = {}, {}, {}
    for nm in names:
        ts = [r.throughput[nm] for r in recs if nm in r.throughput]
        tput[nm] = float(np.mean(ts))
        p99[nm] = float(np.mean([r.p99[nm] for r in recs if nm in r.p99]))
        fmmr[nm] = float(np.mean([r.fmmr_true[nm] for r in recs if nm in r.fmmr_true]))
    agg = float(np.mean([sum(r.throughput.values()) for r in recs])) if recs else 0.0
    all_p99 = [v for r in recs for v in r.p99.values()]
    depths = [r.queue_depth for r in recs]
    return PhaseStats(
        label=label, start=start, end=end,
        throughput=tput, p99=p99, fmmr=fmmr,
        agg_throughput=agg,
        mean_p99=float(np.mean(all_p99)) if all_p99 else 0.0,
        migrated_pages=int(sum(r.migrated_pages for r in recs)),
        migration_bytes=float(sum(r.migration_bytes for r in recs)),
        mean_queue_depth=float(np.mean(depths)) if depths else 0.0,
        max_queue_depth=int(max(depths, default=0)),
    )


# --------------------------------------------------------- responsiveness
def recovery_epochs(
    history,
    event_epoch: int,
    frac: float = 0.95,
    baseline_window: int = 8,
    tenant: Optional[str] = None,
) -> Tuple[int, float]:
    """Jenga-style responsiveness: epochs after ``event_epoch`` until
    throughput regains ``frac`` of its pre-event mean, measured from the
    event to the END of the post-event dip (with chunked records the first
    post-event epochs can still carry pre-shift telemetry, so the dip is
    located first; no dip at all counts as instant recovery).

    ``tenant`` selects one tenant's throughput as the observable — the
    right probe for a working-set shift, because the aggregate MASKS the
    dip (a missing LS tenant frees bandwidth and the batch tenants speed
    up). ``None`` scores the aggregate. Returns (epochs, baseline).

    This is the PR 8 online-tuner metric promoted into the scenario
    engine; the reference's ``launch/hillclimb.py`` re-exports it."""
    if tenant is None:
        agg = np.array([sum(r.throughput.values()) for r in history], float)
    else:
        agg = np.array([r.throughput.get(tenant, 0.0) for r in history], float)
    lo = max(0, event_epoch - baseline_window)
    base = float(agg[lo:event_epoch].mean()) if event_epoch > lo else float(agg.mean())
    after = agg[event_epoch:]
    target = frac * base
    below = after < target
    if not below.any():
        return 0, base
    dip = int(np.argmax(below))
    hit = after[dip:] >= target
    if not hit.any():
        return len(after), base
    return dip + int(np.argmax(hit)), base


def churn_recovery_epochs(history, event_epoch: int) -> int:
    """Queue-axis twin of :func:`recovery_epochs`: epochs after
    ``event_epoch`` until the migration queue's enqueue/drain balance
    first goes non-positive — the epoch the control plane stops selecting
    more work than the data plane commits, i.e. the queue storm the event
    kicked off has subsided. A policy whose balance never recovers (it
    keeps overflowing the FIFO with selections that are dropped and
    re-selected every epoch) scores the whole remaining window — the
    saturated worst case the adversarial bench gates against.

    Throughput masks this failure mode entirely: two managers with
    identical committed migrations (identical throughput timelines) can
    differ 10x in enqueue work, and only the flow counters
    (``EpochRecord.queue_enqueued``/``queue_drained``) expose it."""
    for i in range(event_epoch, len(history)):
        if history[i].queue_enqueued - history[i].queue_drained <= 0:
            return i - event_epoch
    return len(history) - event_epoch


@dataclass
class ResponsivenessStats(PhaseStats):
    """:class:`PhaseStats` plus the adversarial-dynamics observables
    (DESIGN.md §11): per-event epochs-to-recover on each affected tenant's
    own throughput, and the phase's storm-health counters.

    ``pingpong_rate`` is cancelled/enqueued — the fraction of enqueue work
    burned on migrations that were later cancelled; every thrash-guard
    reheat cancel is one leg of a promote <-> demote ping-pong on that
    page, so a rate near 1 means the queue is churning, not migrating.
    ``cancel_ratio`` (cancelled/drained) is the livelock indicator the
    adversarial bench gates on."""

    recovery: Dict[str, int] = field(default_factory=dict)
    enqueued: int = 0
    drained: int = 0
    cancelled: int = 0
    cancel_ratio: float = 0.0
    pingpong_rate: float = 0.0

    def to_jsonable(self) -> dict:
        d = super().to_jsonable()
        d.update(
            recovery_epochs=self.recovery,
            queue_enqueued=self.enqueued,
            queue_drained=self.drained,
            queue_cancelled=self.cancelled,
            cancel_ratio=self.cancel_ratio,
            pingpong_rate=self.pingpong_rate,
        )
        return d


def _affected_tenants(evs) -> List[str]:
    """Tenants whose own throughput the recovery probe should watch. An
    arriving tenant has no pre-event baseline and a departing one no
    post-event signal, so both are skipped; machine-/bandwidth-level
    events affect everyone and fall back to the aggregate probe."""
    names = set()
    for ev in evs:
        if isinstance(ev, (Arrive, Depart)):
            continue
        nm = getattr(ev, "name", None)
        if nm is not None:
            names.add(nm)
    return sorted(names)


def responsiveness_phases(
    result: ScenarioResult,
    frac: float = 0.95,
    baseline_window: int = 8,
) -> List["ResponsivenessStats"]:
    """Recompute ``result``'s phases as :class:`ResponsivenessStats`.

    Each phase opened by events gets per-affected-tenant epochs-to-recover
    (measured over the remaining history, not just the phase — a dip may
    outlive its phase); phases whose events name no tenant use the
    aggregate probe under the key ``"*"``. Storm-health counters sum the
    per-epoch queue flow the simulator records."""
    history = result.history
    out: List[ResponsivenessStats] = []
    for ps in result.phases:
        recs = history[ps.start:ps.end]
        enq = sum(r.queue_enqueued for r in recs)
        drn = sum(r.queue_drained for r in recs)
        can = sum(r.queue_cancelled for r in recs)
        recovery: Dict[str, int] = {}
        evs = result.scenario.events_at(ps.start)
        if evs and ps.start > 0:  # epoch-0 events have no baseline window
            names = _affected_tenants(evs)
            if names:
                for nm in names:
                    ep, _base = recovery_epochs(
                        history, ps.start, frac=frac,
                        baseline_window=baseline_window, tenant=nm,
                    )
                    recovery[nm] = ep
            else:
                ep, _base = recovery_epochs(
                    history, ps.start, frac=frac, baseline_window=baseline_window
                )
                recovery["*"] = ep
        out.append(ResponsivenessStats(
            **vars(ps),
            recovery=recovery,
            enqueued=enq,
            drained=drn,
            cancelled=can,
            cancel_ratio=float(can) / max(drn, 1),
            pingpong_rate=float(can) / max(enq, 1),
        ))
    return out


def storm_health(result: ScenarioResult, frac: float = 0.95) -> dict:
    """Scenario-level storm summary the adversarial bench gates on:
    worst per-event recovery, whole-run cancel/drain ratio and ping-pong
    rate, plus the per-phase breakdown."""
    phases = responsiveness_phases(result, frac=frac)
    enq = sum(p.enqueued for p in phases)
    drn = sum(p.drained for p in phases)
    can = sum(p.cancelled for p in phases)
    worst = max(
        (max(p.recovery.values()) for p in phases if p.recovery), default=0
    )
    return {
        "worst_recovery_epochs": int(worst),
        "recovery_epochs": {
            f"{p.start}:{p.label}": p.recovery for p in phases if p.recovery
        },
        "enqueued": int(enq),
        "drained": int(drn),
        "cancelled": int(can),
        "cancel_ratio": float(can) / max(drn, 1),
        "pingpong_rate": float(can) / max(enq, 1),
        "phases": [p.to_jsonable() for p in phases],
    }


# ---------------------------------------------------------------- executor
def _collect_phases(sim: ColocationSim, scenario: Scenario, base: int) -> ScenarioResult:
    history = sim.history[base : base + scenario.n_epochs]
    phases = [
        _phase_stats(history, start, end, label)
        for start, end, label in scenario.phase_spans()
    ]
    return ScenarioResult(scenario=scenario, history=history, phases=phases)


def run_scenario(
    sim: ColocationSim,
    scenario: Scenario,
    on_event: Optional[Callable] = None,
) -> ScenarioResult:
    """Execute ``scenario`` on ``sim`` (any backend) and aggregate phases.

    ``on_event(sim, event)`` is called after each event is applied — the
    differential test harness uses it to assert invariants at every
    perturbation point.
    """
    base = len(sim.history)
    by_epoch: Dict[int, List[ScenarioEvent]] = {}
    for ev in scenario.events:
        by_epoch.setdefault(base + ev.epoch, []).append(ev)

    def fire(s: ColocationSim, evs=None) -> None:
        for ev in evs:
            ev.apply(s)
            if on_event is not None:
                on_event(s, ev)

    events = {
        epoch: (lambda s, evs=evs: fire(s, evs)) for epoch, evs in by_epoch.items()
    }
    sim.run(scenario.n_epochs, events)
    return _collect_phases(sim, scenario, base)
