"""The port's scenario sweep (``repro_torch.core.scenario.run_sweep``).

* Against the reference's ``run_sweep``: four points (seed x budget) on
  one timeline of arrivals, a resize and a departure, 4 KiB pages and
  40 us epochs (so exact counts stay inside the heat bins and pages move),
  ``policy_chunk`` 4, ``sample_period`` 1 (both samplers then return the
  exact counts), in instant and queue mode: every epoch record equal,
  floats exact, and the phases equal.
* On the port: the pipelined and the serial driving give the same
  histories, sampled; and the sweep equals each point run alone as a
  chunked scenario (``ColocationSim(policy_chunk=4)``), sampled, because
  each machine draws its deviates from its own generator in a fleet as
  alone (the port's form of ``tests/test_fleet.py:285-342``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.scenario as jax_sc
import repro.core.simulator as jax_sim
import repro_torch.core.scenario as torch_sc
import repro_torch.core.simulator as torch_sim
from repro_torch.core.manager import CentralManager

P, FAST, BUDGET, CHUNK, EPOCH_S = 1024, 256, 32, 4, 4e-5


def _timeline(S):
    W = S.WorkloadSpec
    return S.Scenario(name="sweep_parity", n_epochs=16, events=(
        S.Arrive(0, W("kvs", n_pages=380, t_miss=0.2, threads=4, sets=((0.2, 0.9),))),
        S.Arrive(0, W("gap", n_pages=260, t_miss=0.5, threads=8, sets=((0.2, 0.7),))),
        S.Arrive(4, W("gups", n_pages=160, t_miss=1.0, threads=8)),
        S.ResizeWorkingSet(8, "kvs", 0, 0.3),
        S.Depart(12, "gups"),
    ))


def _points(S, queue: bool):
    """Four points: two seeds x two budgets (x two bandwidths in queue mode)."""
    return tuple(
        S.SweepPoint(name=f"m{i}", seed=i // 2, migration_budget=(BUDGET, BUDGET // 2)[i % 2],
                     migration_bandwidth=(8 + 4 * i) if queue else None,
                     migration_latency=i % 2 if queue else 0)
        for i in range(4)
    )


def _texts(result):
    return {name: [repr(dataclasses.asdict(r)) for r in res.history]
            for name, res in result.results.items()}


def _phases(result):
    return {name: [repr(dataclasses.asdict(ph)) for ph in res.phases]
            for name, res in result.results.items()}


def _machine(S):
    return dataclasses.replace(S.OPTANE, page_bytes=4096)


@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_sweep_matches_reference(queue):
    kw = dict(num_pages=P, fast_capacity=FAST, migration_budget=BUDGET, max_tenants=8,
              policy_chunk=CHUNK, sample_period=1, epoch_seconds=EPOCH_S,
              queue_size=64 if queue else 0)
    want = jax_sc.run_sweep(
        jax_sc.ScenarioSweep(scenario=_timeline(jax_sc), points=_points(jax_sc, queue)),
        machine=_machine(jax_sim), **kw)
    got = torch_sc.run_sweep(
        torch_sc.ScenarioSweep(scenario=_timeline(torch_sc), points=_points(torch_sc, queue)),
        machine=_machine(torch_sim), device="cpu", **kw)
    assert _texts(got) == _texts(want)
    assert _phases(got) == _phases(want)
    moved = [sum(r.migrated_pages for r in res.history) for res in got.results.values()]
    assert min(moved) > 0, moved
    assert (got.fallbacks, got.restores, got.partial) == (0, 0, False)


def test_pipelined_equals_serial():
    kw = dict(num_pages=P, fast_capacity=FAST, migration_budget=BUDGET, max_tenants=8,
              policy_chunk=CHUNK, queue_size=64, device="cpu")
    sweep = torch_sc.ScenarioSweep(scenario=_timeline(torch_sc), points=_points(torch_sc, True))
    piped = torch_sc.run_sweep(sweep, pipeline=True, **kw)
    serial = torch_sc.run_sweep(sweep, pipeline=False, **kw)
    assert piped.pipeline and not serial.pipeline
    assert _texts(piped) == _texts(serial)
    assert piped.to_jsonable()["machines"] == serial.to_jsonable()["machines"]


def test_sweep_equals_serial_chunked_scenarios():
    """run_sweep == each point's ColocationSim(policy_chunk=4) scenario run:
    the same chunk boundaries, access-noise streams and deviates."""
    points = tuple(torch_sc.SweepPoint(name=f"m{i}", seed=i, migration_budget=24 + 8 * i)
                   for i in range(3))
    sc = _timeline(torch_sc)
    out = torch_sc.run_sweep(
        torch_sc.ScenarioSweep(scenario=sc, points=points), num_pages=P, fast_capacity=FAST,
        migration_budget=BUDGET, max_tenants=8, policy_chunk=CHUNK, device="cpu")
    for p in points:
        mgr = CentralManager(num_pages=P, fast_capacity=FAST, migration_budget=p.migration_budget,
                             max_tenants=8, sample_period=100, seed=p.seed, device="cpu")
        sim = torch_sim.ColocationSim(mgr, torch_sim.OPTANE, seed=p.seed, policy_chunk=CHUNK)
        want = sim.run_scenario(sc)
        got = out.results[p.name]
        assert [repr(dataclasses.asdict(r)) for r in got.history] == \
            [repr(dataclasses.asdict(r)) for r in want.history]
        assert [ph.agg_throughput for ph in got.phases] == \
            [ph.agg_throughput for ph in want.phases]


def test_sweep_point_names_unique():
    sc = torch_sc.Scenario(name="x", n_epochs=4)
    with pytest.raises(AssertionError):
        torch_sc.ScenarioSweep(scenario=sc, points=(
            torch_sc.SweepPoint(name="a"), torch_sc.SweepPoint(name="a", seed=1),
        ))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-GPU refusal")
def test_sweep_runs_on_the_card_unless_asked():
    sweep = torch_sc.ScenarioSweep(scenario=_timeline(torch_sc),
                                   points=(torch_sc.SweepPoint(name="a"),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_sc.run_sweep(sweep, num_pages=P, fast_capacity=FAST, migration_budget=BUDGET)


def test_sweep_knobs_reach_each_machine():
    """Every SweepPoint knob lands on its machine's params."""
    seen = {}
    point = torch_sc.SweepPoint(
        name="a", seed=3, migration_budget=20, migration_bandwidth=5, migration_latency=2,
        sample_period=7, ewma_lambda=0.25, hysteresis=0.1, num_bins=7, alloc_headroom=3,
        fast_capacity=200, promote_band=0.2, demote_band=0.05, promote_admission=6,
        demote_cooldown=4,
    )
    torch_sc.run_sweep(
        torch_sc.ScenarioSweep(scenario=torch_sc.Scenario(name="idle", n_epochs=2),
                               points=(point,)),
        num_pages=P, fast_capacity=FAST, migration_budget=BUDGET, queue_size=16,
        device="cpu", on_fleet=lambda f: seen.setdefault("p", f.machines[0].params))
    p = seen["p"]
    assert (p.migration_budget, p.migration_bandwidth, p.migration_latency, p.sample_period,
            p.num_bins, p.alloc_headroom, p.fast_capacity, p.promote_admission,
            p.demote_cooldown) == (20, 5, 2, 7, 7, 3, 200, 6, 4)
    assert (p.ewma_lambda, p.hysteresis, p.promote_band, p.demote_band) == tuple(
        float(np.float32(v)) for v in (0.25, 0.1, 0.2, 0.05))
