"""The port's colocation simulator (``repro_torch.core.simulator``).

Two kinds of test. The nine property tests of ``tests/test_simulator.py``
run on the port with its own sampler (a ``torch.Generator`` stream, so the
numbers differ from the reference's but the paper's dynamics must hold at
the same sizes and thresholds). The parity tests run the port and the
reference with exact sampling on the same seeds: the simulator's numpy
streams and float64 cost model then give equal epoch records, floats
exact, through ``run_epoch`` and the chunked ``run_epochs`` path.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.manager import CentralManager as JaxManager
from repro.core.simulator import OPTANE as JAX_OPTANE
from repro.core.simulator import ColocationSim as JaxSim
from repro.core.simulator import WorkloadSpec as JaxSpec
from repro_torch.core.baselines import AutoNUMALike, HeMemStatic, TwoLM
from repro_torch.core.manager import CentralManager
from repro_torch.core.simulator import OPTANE, ColocationSim, WorkloadSpec


def _maxmem(num_pages=512, fast=128, budget=64, **kw):
    return CentralManager(
        num_pages=num_pages, fast_capacity=fast, migration_budget=budget, max_tenants=8,
        sample_period=kw.pop("sample_period", 10), device="cpu", **kw,
    )


def _gups():
    # hot = 1/7 of pages (64), warm 2/7 (128): hot + warm > fast capacity
    return WorkloadSpec("gups", n_pages=448, t_miss=0.1, threads=4,
                        sets=((1 / 7, 0.6), (2 / 7, 0.3)))


# ---------------------------------------------------------------- properties
def test_single_tenant_converges_to_hot_set():
    sim = ColocationSim(_maxmem(), OPTANE, seed=0)
    sim.add_tenant(_gups())
    sim.run(40)
    rec = sim.history[-1]
    assert rec.fmmr_true["gups"] < 0.45
    assert rec.throughput["gups"] > 0


def test_heat_gradient_beats_threshold_when_oversubscribed():
    """Paper Fig. 3 (256 GB point): MaxMem well above HeMem's throughput."""
    def scenario(backend):
        sim = ColocationSim(backend, OPTANE, seed=1)
        sim.add_tenant(_gups())
        sim.run(50)
        return np.mean([r.throughput["gups"] for r in sim.history[-10:]])

    mm = scenario(_maxmem())
    ht = scenario(HeMemStatic(num_pages=512, fast_capacity=128, hot_threshold=4,
                              migration_budget=64, partitions={0: 128}))
    assert mm > 1.2 * ht, f"MaxMem {mm:.0f} ops/s vs HeMem {ht:.0f}"


def test_colocation_all_targets_met():
    """Five LS tenants (t=0.1) + one BE (t=1.0) reach their targets (Fig. 4)."""
    sim = ColocationSim(_maxmem(num_pages=2048, fast=640, budget=128), OPTANE, seed=2)
    sim.add_tenant(WorkloadSpec("be", n_pages=256, t_miss=1.0, threads=2))
    for i in range(5):
        sim.add_tenant(WorkloadSpec(f"ls{i}", n_pages=256, t_miss=0.1, threads=2,
                                    sets=((0.45, 0.9),)))
    sim.run(60)
    rec = sim.history[-1]
    for i in range(5):
        assert rec.fmmr_true[f"ls{i}"] <= 0.15, (i, rec.fmmr_true[f"ls{i}"])


def test_dynamic_arrival_reallocates():
    sim = ColocationSim(_maxmem(num_pages=1024, fast=256, budget=128), OPTANE, seed=3)
    sim.add_tenant(WorkloadSpec("be", n_pages=512, t_miss=1.0, threads=4))
    sim.run(10)
    be_fast_before = sim.history[-1].fast_pages["be"]
    sim.add_tenant(WorkloadSpec("ls", n_pages=384, t_miss=0.1, threads=4, sets=((0.5, 0.95),)))
    sim.run(40)
    rec = sim.history[-1]
    assert rec.fast_pages["ls"] > 100
    assert rec.fast_pages["be"] < be_fast_before
    assert rec.fmmr_true["ls"] <= 0.15


def test_hot_set_growth_detected_and_served():
    """Paper Fig. 4 event 5: hot set grows 50% -> FMMR spike -> reconverge."""
    sim = ColocationSim(_maxmem(num_pages=1024, fast=320, budget=128), OPTANE, seed=4)
    sim.add_tenant(WorkloadSpec("ls", n_pages=512, t_miss=0.1, threads=4, sets=((0.4, 0.9),)))
    sim.add_tenant(WorkloadSpec("be", n_pages=384, t_miss=1.0, threads=2))
    sim.run(30)
    fmmr_before = sim.history[-1].fmmr_true["ls"]
    sim.tenants["ls"].resize_set(0, 0.6)
    sim.run(1)
    spike = sim.history[-1].fmmr_true["ls"]
    sim.run(40)
    assert spike > fmmr_before + 0.02, "growth not visible in FMMR"
    assert sim.history[-1].fmmr_true["ls"] <= 0.15


@pytest.mark.parametrize("backend", [AutoNUMALike, TwoLM], ids=lambda b: b.__name__)
def test_baselines_no_qos_interference(backend):
    """AutoNUMA / 2LM: the BE tenant steals fast memory from the LS tenant."""
    sim = ColocationSim(backend(num_pages=1024, fast_capacity=256), OPTANE, seed=5)
    sim.add_tenant(WorkloadSpec("ls", n_pages=384, t_miss=0.1, threads=2, sets=((0.5, 0.9),)))
    sim.add_tenant(WorkloadSpec("be", n_pages=512, t_miss=1.0, threads=8))
    sim.run(40)
    assert sim.history[-1].fmmr_true["ls"] > 0.15


def test_maxmem_vs_baselines_ls_qos():
    def run(backend):
        sim = ColocationSim(backend, OPTANE, seed=6)
        sim.add_tenant(WorkloadSpec("ls", n_pages=384, t_miss=0.1, threads=2,
                                    sets=((0.5, 0.9),)))
        sim.add_tenant(WorkloadSpec("be", n_pages=512, t_miss=1.0, threads=8))
        sim.run(50)
        return sim.history[-1]

    mm = run(_maxmem(num_pages=1024, fast=256, budget=128))
    an = run(AutoNUMALike(num_pages=1024, fast_capacity=256))
    assert mm.fmmr_true["ls"] < an.fmmr_true["ls"]
    assert mm.p99["ls"] <= an.p99["ls"]


def test_policy_chunk_scan_path_converges_like_single_stepping():
    def scenario(chunk):
        sim = ColocationSim(_maxmem(), OPTANE, seed=11, policy_chunk=chunk)
        sim.add_tenant(_gups())
        sim.run(40)
        return sim

    single, chunked = scenario(1), scenario(8)
    assert len(chunked.history) == 40
    assert chunked.history[-1].fmmr_true["gups"] < 0.45
    assert abs(chunked.history[-1].fmmr_true["gups"]
               - single.history[-1].fmmr_true["gups"]) < 0.15
    assert [r.epoch for r in chunked.history] == list(range(40))


def test_policy_chunk_respects_events():
    sim = ColocationSim(_maxmem(), OPTANE, seed=12, policy_chunk=16)
    sim.add_tenant(WorkloadSpec("a", n_pages=256, t_miss=0.5, threads=2, sets=((0.25, 0.9),)))
    fired = []
    sim.run(20, events={10: lambda s: fired.append(len(s.history))})
    assert fired == [10]
    assert len(sim.history) == 20


# ---------------------------------------------------------------- parity
def _records(history):
    """Epoch records as text: ``repr`` of a float is exact (and tells -0.0
    and NaN apart), so equal text is bit-equal records."""
    return [repr(dataclasses.asdict(r)) for r in history]


EPOCH_S = 4e-5


def _drive(mod_manager, Sim, Spec, machine, chunk, queue, **kw):
    mkw = dict(num_pages=512, fast_capacity=128, migration_budget=64, max_tenants=8,
               sample_period=10, exact_sampling=True, seed=3)
    if queue:
        mkw.update(queue_size=128, migration_bandwidth=16, migration_latency=1)
    m = mod_manager(**mkw, **kw)
    # 4 KiB pages and a 40 us epoch: exact counts a page stay inside the
    # heat bins (so pages move), and an epoch's migrations fit in it
    sim = Sim(m, dataclasses.replace(machine, page_bytes=4096), epoch_seconds=EPOCH_S,
              seed=9, policy_chunk=chunk)
    sim.add_tenant(Spec("gups", n_pages=448 - 96, t_miss=0.1, threads=4,
                        sets=((1 / 7, 0.6), (2 / 7, 0.3))))
    sim.add_tenant(Spec("be", n_pages=96, t_miss=1.0, threads=2))
    events = {
        6: lambda s: s.tenants["gups"].resize_set(0, 0.3),
        11: lambda s: s.set_target("be", 0.4),
        15: lambda s: s.tenants["gups"].shift_sets(),
        19: lambda s: s.remove_tenant("be"),
    }
    sim.run(24, events=events)
    return sim, m


@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_simulator_matches_reference_with_exact_sampling(chunk, queue):
    js, jm = _drive(JaxManager, JaxSim, JaxSpec, JAX_OPTANE, chunk, queue)
    ts, tm = _drive(CentralManager, ColocationSim, WorkloadSpec, OPTANE, chunk, queue,
                    device="cpu")
    assert len(ts.history) == 24
    assert sum(r.migrated_pages for r in js.history) > 0
    assert _records(ts.history) == _records(js.history)
    assert np.array_equal(tm.tiers(), np.asarray(jm.tiers()))
    assert np.array_equal(tm.owners(), np.asarray(jm.owners()))
    if queue:
        assert tm.queue_counters() == jm.queue_counters()
