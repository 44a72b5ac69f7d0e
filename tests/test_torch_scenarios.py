"""The port's scenario engine (``repro_torch.core.scenario``) against the
reference's.

Each case runs one timeline through the reference (JAX manager, reference
simulator and engine) and through the port (the port's manager on the CPU,
its simulator and engine), both with exact sampling and the same seeds, at
``policy_chunk`` 1 (``run_epoch``) and 4 (``run_epochs``). The epoch
records (floats exact), ``PhaseStats``, ``churn_recovery_epochs``,
``responsiveness_phases``, ``storm_health`` and the final placement and
queue counters must be equal. The port's runs also hold the conservation
invariants of ``tests/test_scenarios.py`` after every event.

The cases: the scripted churn of ``tests/test_scenarios.py``, every storm
family and the composite storm, a ``SetMigrationBandwidth`` +
``BandwidthDegrade`` schedule on a queue-mode manager, a
``BandwidthDegrade`` schedule on an instant one, a ``DataPlaneError``
schedule on a manager with a page pool (its frames compared too) and a
``TelemetryCorrupt`` schedule with the sentinel on. Pages are 4
KiB and epochs 40 us, so exact access counts stay inside the heat bins and
pages move.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.scenario as jax_sc
import repro.core.simulator as jax_sim
import repro_torch.core.scenario as torch_sc
import repro_torch.core.simulator as torch_sim
from repro.core.manager import CentralManager as JaxManager
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import TIER_FAST, TIER_NONE, TIER_SLOW

P, FAST, BUDGET, ELEMS, EPOCH_S = 256, 64, 32, 8, 4e-5

MANAGERS = {
    "instant": {},
    "queue": dict(queue_size=2 * BUDGET, migration_bandwidth=BUDGET // 4, migration_latency=1),
    "guarded": dict(queue_size=2 * BUDGET, migration_bandwidth=BUDGET // 4, migration_latency=1,
                    promote_band=0.12, demote_band=0.04, promote_admission=BUDGET // 4,
                    demote_cooldown=3),
    "pool": dict(queue_size=2 * BUDGET, migration_bandwidth=BUDGET // 4, migration_latency=1,
                 data_plane_elems=ELEMS, sentinel=True),
    "sentinel": dict(queue_size=2 * BUDGET, migration_bandwidth=BUDGET // 4, migration_latency=1,
                     sentinel=True),
}


def _scripted(S):
    W = S.WorkloadSpec
    return S.Scenario(name="scripted_churn", n_epochs=30, events=(
        S.Arrive(0, W("a", 96, t_miss=0.2, threads=2, sets=((0.3, 0.9),))),
        S.Arrive(0, W("b", 64, t_miss=1.0, threads=4)),
        S.Arrive(6, W("c", 48, t_miss=0.5, threads=2, sets=((0.5, 0.8),))),
        S.ResizeWorkingSet(10, "a", 0, 0.45),
        S.SkewChange(14, "c", 0, 0.5),
        S.ShiftWorkingSet(18, "a"),
        S.Retarget(20, "b", 0.5),
        S.Depart(24, "b"),
        S.Arrive(26, W("d", 32, t_miss=1.0, threads=2)),
    ))


def _bandwidth(S):
    W = S.WorkloadSpec
    return S.Scenario(name="bandwidth", n_epochs=28, events=(
        S.Arrive(0, W("a", 96, t_miss=0.2, threads=2, sets=((0.3, 0.9),))),
        S.Arrive(0, W("b", 64, t_miss=0.6, threads=4, sets=((0.25, 0.8),))),
        S.SetMigrationBandwidth(4, 2),
        *S.pingpong_schedule("a", 8, 20, 4),
        S.SetMigrationBandwidth(10, None),
        S.BandwidthDegrade(13, 0.25),
        S.Depart(20, "b"),
        S.BandwidthDegrade(24, 1.0),
    ))


def _degrade(S):
    W = S.WorkloadSpec
    return S.Scenario(name="degrade", n_epochs=24, events=(
        S.Arrive(0, W("a", 96, t_miss=0.2, threads=2, sets=((0.3, 0.9),))),
        S.Arrive(0, W("b", 96, t_miss=1.0, threads=4)),
        S.BandwidthDegrade(6, 0.25),
        S.ShiftWorkingSet(10, "a"),
        S.BandwidthDegrade(16, 1.0),
    ))


def _dma_errors(S):
    W = S.WorkloadSpec
    return S.Scenario(name="dma_errors", n_epochs=24, events=(
        S.Arrive(0, W("a", 96, t_miss=0.2, threads=2, sets=((0.3, 0.9),))),
        S.Arrive(0, W("b", 64, t_miss=1.0, threads=4)),
        S.DataPlaneError(4, 0.3, max_retries=1, seed=5),
        S.ShiftWorkingSet(8, "a"),
        S.DataPlaneError(15, 0.0),
    ))


def _poison(S):
    # no page pool here: the reference's pool cannot move a page whose tier
    # was unplaced (its free-frame list runs dry), so the poison runs alone
    W = S.WorkloadSpec
    return S.Scenario(name="poison", n_epochs=24, events=(
        S.Arrive(0, W("a", 96, t_miss=0.2, threads=2, sets=((0.3, 0.9),))),
        S.Arrive(0, W("b", 64, t_miss=1.0, threads=4)),
        S.TelemetryCorrupt(8, "tier"),
        S.ShiftWorkingSet(12, "a"),
        S.TelemetryCorrupt(16, "nan"),
    ))


CASES = {
    "scripted": ("instant", _scripted),
    **{f"storm-{f}": ("queue", lambda S, f=f: S.storm_scenario(f, P, 24))
       for f in jax_sc.STORM_FAMILIES},
    "composite": ("guarded", lambda S: S.adversarial_scenario(P, 32, fast_capacity=FAST)),
    "bandwidth": ("queue", _bandwidth),
    "degrade-instant": ("instant", _degrade),
    "dma-errors": ("pool", _dma_errors),
    "poison": ("sentinel", _poison),
}


def check_invariants(sim, event=None):
    """The conservation invariants of ``tests/test_scenarios.py``."""
    backend = sim.backend
    tier = np.asarray(backend.tiers())
    owner = np.asarray(backend.owners())
    ctx = f"after {event}" if event is not None else "after epoch"
    assert set(np.unique(tier).tolist()) <= {TIER_NONE, TIER_SLOW, TIER_FAST}, ctx
    owned = owner >= 0
    assert (tier[owned] != TIER_NONE).all(), f"owned page unplaced {ctx}"
    assert (tier[~owned] == TIER_NONE).all(), f"unowned page placed {ctx}"
    registered = {int(h) for h in sim.handles.values()}
    assert set(np.unique(owner[owned]).tolist()) <= registered, ctx
    assert int((tier == TIER_FAST).sum()) <= int(backend.params.fast_capacity), ctx
    if backend.queue_size:
        c = backend.queue_counters()
        assert c["enqueued"] == c["drained"] + c["cancelled"] + c["dropped"] + c["depth"], ctx


def _run(S, Sim, make, case, chunk, on_event=None):
    kind, build = CASES[case]
    m = make(num_pages=P, fast_capacity=FAST, migration_budget=BUDGET, max_tenants=8,
             sample_period=10, exact_sampling=True, seed=4, **MANAGERS[kind])
    machine = dataclasses.replace(Sim.OPTANE, page_bytes=4096)
    sim = Sim.ColocationSim(m, machine, epoch_seconds=EPOCH_S, seed=17, policy_chunk=chunk)
    return m, sim, S.run_scenario(sim, build(S), on_event=on_event)


def _text(x):
    """``repr`` of dataclasses as dicts: exact floats, NaN and -0.0 told apart."""
    if isinstance(x, list):
        return [_text(v) for v in x]
    return repr(dataclasses.asdict(x)) if dataclasses.is_dataclass(x) else repr(x)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_scenario_matches_reference(case, chunk):
    jm, _, jr = _run(jax_sc, jax_sim, JaxManager, case, chunk)
    poisoned = case == "poison"  # an unplaced owned page is the fault itself

    def on_event(sim, ev):
        if not poisoned:
            check_invariants(sim, ev)

    tm, ts, tr = _run(torch_sc, torch_sim, lambda **kw: CentralManager(device="cpu", **kw),
                  case, chunk, on_event)
    n = tr.scenario.n_epochs
    assert len(tr.history) == n
    assert sum(r.migrated_pages for r in jr.history) > 0
    assert _text(tr.history) == _text(jr.history)
    assert _text(tr.phases) == _text(jr.phases)
    starts = [s for s, _e, _l in jr.scenario.phase_spans() if s > 0]
    assert ([torch_sc.churn_recovery_epochs(tr.history, s) for s in starts]
            == [jax_sc.churn_recovery_epochs(jr.history, s) for s in starts])
    assert _text(torch_sc.responsiveness_phases(tr)) == _text(jax_sc.responsiveness_phases(jr))
    assert repr(torch_sc.storm_health(tr)) == repr(jax_sc.storm_health(jr))
    assert np.array_equal(tm.tiers(), np.asarray(jm.tiers()))
    assert np.array_equal(tm.owners(), np.asarray(jm.owners()))
    assert tm.queue_counters() == jm.queue_counters()
    assert tm.migration_failures == jm.migration_failures
    if not poisoned:
        check_invariants(ts)
    if tm.pool is not None:
        assert tm.migration_failures > 0
        owned = np.flatnonzero(tm.owners() >= 0)
        assert np.array_equal(np.asarray(tm.pool.frame)[owned], np.asarray(jm.pool.frame)[owned])
