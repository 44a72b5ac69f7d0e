"""The port's sharded fleet: ``FleetManager(devices=[...])`` splits the
padded machine axis into one contiguous slice per device and runs the
batched tick on each slice on its device.

The contracts of ``tests/test_fleet_sharded.py`` on the port, at the device
lists ``["cpu"] * 2``, ``["cpu"] * 3`` and ``["cpu"] * 4`` (slices that
split a fleet of K = 3 or 5 machines unevenly, padded to a multiple of the
device count with inert machines):

* every machine's telemetry, plans, final state and queue counters equal
  the unsharded fleet's and its own run alone, sampled (each machine draws
  its deviates from its own generator), in instant and queue mode; with
  exact sampling also the reference's fleet;
* the inert padding rows stay inert across churn between dispatches;
* the device count is validated (``ValueError``, where the reference
  asserts);
* dirty tracking holds per slice: a no-op dispatch stacks and uploads
  nothing on any slice, a control-plane operation re-uploads only its
  machine, into its own slice, and a params-only change restacks no state;
* ``tests/golden/fleet_trace.json`` replays bit for bit at each list;
* the pipelined sharded sweep equals the unpipelined single-device sweep
  and each point run alone.

Tolerance: none. Integer and float leaves are compared by their bits.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import golden_regen
import repro_torch.core.fleet as fleet_mod
import repro_torch.core.scenario as torch_sc
import repro_torch.core.simulator as torch_sim
from repro.core.fleet import FleetManager as JaxFleet
from repro.core.manager import CentralManager as JaxManager
from repro_torch.core.fleet import FleetManager
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import state_to_numpy

P, T, E = 1024, 8, 6
LISTS = {"cpu2": ["cpu"] * 2, "cpu3": ["cpu"] * 3, "cpu4": ["cpu"] * 4}
BATCHING_RULE = ".*batching rule.*"


@pytest.fixture(autouse=True)
def _no_batching_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=BATCHING_RULE)
        yield


def _configs(queue: bool, n: int):
    """n machines with differing knobs (tests/test_fleet_sharded.py:57)."""
    if queue:
        return [dict(seed=s, migration_budget=32 + 16 * s, queue_size=128,
                     migration_bandwidth=8 + 8 * s, migration_latency=s % 2) for s in range(n)]
    return [dict(seed=s, migration_budget=32 + 16 * s) for s in range(n)]


def _mk(kw, exact=False):
    m = CentralManager(num_pages=P, fast_capacity=256, max_tenants=T, sample_period=100,
                       exact_sampling=exact, device="cpu", **kw)
    hs = []
    for t_miss, n in ((0.1, 300), (0.5, 300), (1.0, 200)):
        h = m.register(t_miss)
        m.allocate(h, n)
        hs.append(h)
    return m, hs


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    a = _np(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _tree_equal(got, want, path=""):
    if got is None or want is None:
        assert got is None and want is None, path
        return
    if hasattr(got, "_fields"):
        for f in got._fields:
            _tree_equal(getattr(got, f), getattr(want, f), f"{path}.{f}")
        return
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=path)


def _machine_equal(a: CentralManager, b: CentralManager):
    _tree_equal(state_to_numpy(a._state), state_to_numpy(b._state), "state")
    assert a.queue_counters() == b.queue_counters()


def _counts(seed, shape, lam=4):
    return np.random.default_rng(seed).poisson(lam, shape).astype(np.int64)


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("devs", list(LISTS))
@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_sharded_matches_unsharded_and_solo(queue, devs, K):
    cfgs = _configs(queue, K)
    counts = _counts(0, (K, E, P))
    sharded = FleetManager([_mk(c)[0] for c in cfgs], devices=LISTS[devs])
    plain = FleetManager([_mk(c)[0] for c in cfgs], devices=1)
    assert sharded.num_shards == len(LISTS[devs]) and plain.num_shards == 1
    assert sharded.num_padded % sharded.num_shards == 0
    res_s = sharded.run_epochs(E, counts=counts, collect_plans=True)
    res_p = plain.run_epochs(E, counts=counts, collect_plans=True)
    assert res_s.num_machines == K  # padding rows are dropped from every leaf
    _tree_equal(res_s.stats, res_p.stats, "stats")
    _tree_equal(res_s.plans, res_p.plans, "plans")
    np.testing.assert_array_equal(res_s.flags, res_p.flags)
    for i, c in enumerate(cfgs):
        solo, _ = _mk(c)
        solo.run_epochs(E, counts=counts[i], collect_plans=True)
        _machine_equal(sharded.machines[i], solo)
        _machine_equal(plain.machines[i], solo)
    tier, owner = sharded.stacked_placement()
    assert tier.shape == (K, P)
    for i in range(K):
        np.testing.assert_array_equal(tier[i], plain.machines[i].tiers())
        np.testing.assert_array_equal(owner[i], plain.machines[i].owners())


@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_sharded_exact_matches_reference_fleet(queue, K):
    """Exact sampling: the port's fleet split over two slices against the
    reference's padded fleet (``pad_to=4``), telemetry and final states."""
    cfgs = _configs(queue, K)
    counts = _counts(1, (K, E, P))
    port = FleetManager([_mk(c, exact=True)[0] for c in cfgs], devices=["cpu", "cpu"])
    refs = []
    for c in cfgs:
        m = JaxManager(num_pages=P, fast_capacity=256, max_tenants=T, sample_period=100,
                       exact_sampling=True, **c)
        for t_miss, n in ((0.1, 300), (0.5, 300), (1.0, 200)):
            m.allocate(m.register(t_miss), n)
        refs.append(m)
    ref = JaxFleet(refs, devices=1, pad_to=4)
    got = port.run_epochs(E, counts=counts, collect_plans=True)
    want = ref.run_epochs(E, counts=counts, collect_plans=True)
    _tree_equal(got.stats, want.stats, "stats")
    _tree_equal(got.plans, want.plans, "plans")
    for i in range(K):
        np.testing.assert_array_equal(port.machines[i].tiers(), np.asarray(refs[i].tiers()))
        assert port.machines[i].queue_counters() == refs[i].queue_counters()


@pytest.mark.parametrize("devs,K", [("cpu2", 3), ("cpu3", 5), ("cpu4", 5)])
def test_padding_machines_stay_inert_across_churn(devs, K):
    cfgs = _configs(True, K)
    c1, c2 = _counts(2, (K, 4, P)), _counts(3, (K, 4, P), lam=6)
    fleet_ms, fleet_hs = zip(*[_mk(c) for c in cfgs])
    solo_ms, solo_hs = zip(*[_mk(c) for c in cfgs])
    fleet = FleetManager(list(fleet_ms), devices=LISTS[devs])
    assert fleet.num_padded > K

    def churn(m, hs):
        owned = np.flatnonzero(np.asarray(m.owners()) == int(hs[1]))
        m.free(hs[1], owned)
        m.unregister(hs[1])
        m.allocate(m.register(0.3), 64)

    fleet.run_epochs(4, counts=c1)
    for m, hs in zip(fleet_ms, fleet_hs):
        churn(m, hs)
    res = fleet.run_epochs(4, counts=c2)
    assert res.num_machines == K and res.flags.shape[0] == K
    for i, (m, hs) in enumerate(zip(solo_ms, solo_hs)):
        m.run_epochs(4, counts=c1[i])
        churn(m, hs)
        m.run_epochs(4, counts=c2[i])
        _machine_equal(fleet_ms[i], m)
        qc = fleet_ms[i].queue_counters()
        assert qc["enqueued"] == qc["drained"] + qc["cancelled"] + qc["dropped"] + qc["depth"]
    # the padding rows: no tenant, no page owned, no backlog, nothing queued
    for sl in fleet._slices:
        for r in range(sl.lo, sl.hi):
            if r >= K:
                st = fleet_mod.machine_slice(sl.fstate, r - sl.lo)
                assert not bool(st.tenants.active.any())
                assert bool((st.pages.owner == -1).all()) and int(st.pending.sum()) == 0
                assert int(st.queue.depth) == 0


def test_device_count_validation(monkeypatch):
    ms = [_mk(c)[0] for c in _configs(False, 3)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices"):
        FleetManager(ms, devices=2)
    for bad in (0, []):
        with pytest.raises(ValueError, match="devices"):
            FleetManager(ms, devices=bad)
    with pytest.raises(ValueError, match="divide over 2 devices"):
        FleetManager(ms, devices=["cpu", "cpu"], pad_to=3)
    one = FleetManager(ms, devices=[torch.device("cpu")])
    assert one.num_shards == 1 and one.num_padded == 3
    assert FleetManager(ms, devices=["cpu"] * 2).num_padded == 4


class _StackSpy:
    """Counts the rows each slice stacks (state and params) while active."""

    def __init__(self, monkeypatch):
        self.state_rows, self.param_rows = [], []
        stack_states, stack_params = fleet_mod.stack_states, fleet_mod.stack_params

        def spy_states(states):
            self.state_rows.append(len(states))
            return stack_states(states)

        def spy_params(plist, device):
            self.param_rows.append(len(plist))
            return stack_params(plist, device)

        monkeypatch.setattr(fleet_mod, "stack_states", spy_states)
        monkeypatch.setattr(fleet_mod, "stack_params", spy_params)

    def clear(self):
        self.state_rows.clear()
        self.param_rows.clear()


@pytest.mark.parametrize("devs", list(LISTS))
def test_noop_dispatch_uploads_nothing_on_any_slice(devs, monkeypatch):
    fleet = FleetManager([_mk(c)[0] for c in _configs(False, 3)], devices=LISTS[devs])
    spy = _StackSpy(monkeypatch)
    fleet.run_epochs(2, counts=_counts(0, (3, P)))
    assert sum(spy.state_rows) == fleet.num_padded  # the first dispatch stacks every row
    fleet.run_epochs(2)
    before = dict(fleet.upload_stats)
    spy.clear()
    fleet.run_epochs(2)
    after = fleet.upload_stats
    assert spy.state_rows == [] and spy.param_rows == []
    assert after["restacked_machines"] == before["restacked_machines"]
    assert after["seg_rebuilds"] == before["seg_rebuilds"]
    assert after["clean_dispatches"] == before["clean_dispatches"] + 1


@pytest.mark.parametrize("devs", list(LISTS))
def test_control_plane_op_restacks_only_touched_machine(devs, monkeypatch):
    fleet = FleetManager([_mk(c)[0] for c in _configs(False, 3)], devices=LISTS[devs])
    counts = _counts(1, (3, P))
    fleet.run_epochs(2, counts=counts)
    fleet.machines[1].allocate(fleet.machines[1].register(0.4), 32)
    spy = _StackSpy(monkeypatch)
    before = dict(fleet.upload_stats)
    fleet.run_epochs(2, counts=counts)
    after = fleet.upload_stats
    assert after["restacked_machines"] == before["restacked_machines"] + 1
    assert after["seg_rebuilds"] == before["seg_rebuilds"] + 1
    assert spy.state_rows == [1]  # one row, into the one slice holding machine 1


@pytest.mark.parametrize("devs", list(LISTS))
def test_params_only_change_skips_state_restack(devs, monkeypatch):
    fleet = FleetManager([_mk(c)[0] for c in _configs(True, 3)], devices=LISTS[devs])
    counts = _counts(2, (3, P))
    fleet.run_epochs(2, counts=counts)
    fleet.machines[0].set_migration_bandwidth(4)
    spy = _StackSpy(monkeypatch)
    before = dict(fleet.upload_stats)
    fleet.run_epochs(2, counts=counts)
    assert fleet.upload_stats["restacked_machines"] == before["restacked_machines"]
    assert spy.state_rows == [] and sum(spy.param_rows) == fleet.num_padded


@pytest.mark.parametrize("devs", list(LISTS))
def test_dirty_results_still_exact(devs):
    cfgs = _configs(True, 3)
    fleet_ms = [_mk(c)[0] for c in cfgs]
    solo_ms = [_mk(c)[0] for c in cfgs]
    fleet = FleetManager(list(fleet_ms), devices=LISTS[devs])
    counts = _counts(3, (3, len(cfgs), 4, P))
    for burst in range(3):
        if burst == 1:
            for m in (fleet_ms[0], solo_ms[0]):
                m.set_migration_bandwidth(6)
        if burst == 2:
            for m in (fleet_ms[2], solo_ms[2]):
                m.allocate(m.register(0.2), 40)
        fleet.run_epochs(4, counts=counts[burst])
        for i, m in enumerate(solo_ms):
            m.run_epochs(4, counts=counts[burst][i])
    for fm, sm in zip(fleet_ms, solo_ms):
        _machine_equal(fm, sm)


@pytest.mark.parametrize("devs", list(LISTS))
def test_sharded_fleet_replays_golden_trace(devs):
    with open(golden_regen.FLEET_TRACE_PATH) as f:
        committed = json.load(f)["machines"]
    machines = []
    for seed, budget in golden_regen.FLEET_MACHINES:
        m = CentralManager(
            num_pages=golden_regen.POLICY_P, fast_capacity=golden_regen.POLICY_FAST,
            migration_budget=budget, max_tenants=golden_regen.POLICY_MAX_T,
            sample_period=100, exact_sampling=True, seed=seed, device="cpu",
        )
        for n_pages, t_miss in golden_regen.POLICY_TENANTS:
            m.allocate(m.register(t_miss), n_pages)
        machines.append(m)
    fleet = FleetManager(machines, devices=LISTS[devs])
    counts = golden_regen.policy_counts()
    res = fleet.run_epochs(golden_regen.POLICY_EPOCHS,
                           counts=np.broadcast_to(counts, (len(fleet),) + counts.shape),
                           collect_plans=True)
    for m, machine in enumerate(committed):
        records = res.machine(m).unstack()
        tier = fleet.machines[m].tiers()
        for e, want in enumerate(machine["epochs"]):
            got = golden_regen.epoch_record(records[e], tier)
            for key in want:
                assert want[key] == got[key], (m, e, key)


def _records(res):
    return [repr(dataclasses.asdict(r)) for r in res.history]


@pytest.mark.parametrize("devs", ["cpu2", "cpu3"])
@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_pipelined_sharded_sweep_matches_unpipelined_and_solo(queue, devs):
    """run_sweep(pipeline=True, devices=[...]) == run_sweep(pipeline=False,
    devices=1) == each point's chunked scenario run, across churn and, in
    queue mode, a bandwidth event mid-sweep."""
    S = torch_sc
    W = torch_sim.WorkloadSpec
    events = [
        S.Arrive(0, W("kvs", n_pages=380, t_miss=0.2, threads=4, sets=((0.2, 0.9),))),
        S.Arrive(0, W("gap", n_pages=260, t_miss=0.5, threads=8, sets=((0.2, 0.7),))),
        S.Arrive(4, W("gups", n_pages=160, t_miss=1.0, threads=8)),
        S.ResizeWorkingSet(8, "kvs", 0, 0.3),
        S.Depart(12, "gups"),
    ]
    if queue:
        events.append(S.SetMigrationBandwidth(8, 8))
    sc = S.Scenario(name="sharded_sweep_parity", n_epochs=16, events=tuple(events))
    points = tuple(S.SweepPoint(name=f"m{i}", seed=i, migration_budget=24 + 8 * i)
                   for i in range(3))
    kw = dict(num_pages=P, fast_capacity=256, migration_budget=32, max_tenants=8,
              policy_chunk=4, queue_size=64 if queue else 0, device="cpu")
    piped = S.run_sweep(S.ScenarioSweep(scenario=sc, points=points), devices=LISTS[devs], **kw)
    plain = S.run_sweep(S.ScenarioSweep(scenario=sc, points=points), devices=1,
                        pipeline=False, trim_stats=False, **kw)
    assert piped.pipeline and not plain.pipeline
    assert piped.devices == len(LISTS[devs]) and plain.devices == 1
    for p in points:
        mgr = CentralManager(num_pages=P, fast_capacity=256, migration_budget=p.migration_budget,
                             max_tenants=8, sample_period=100, seed=p.seed,
                             queue_size=64 if queue else 0, device="cpu")
        want = torch_sim.ColocationSim(mgr, torch_sim.OPTANE, seed=p.seed,
                                       policy_chunk=4).run_scenario(sc)
        for got in (piped.results[p.name], plain.results[p.name]):
            assert _records(got) == _records(want)
            assert [repr(dataclasses.asdict(ph)) for ph in got.phases] == \
                [repr(dataclasses.asdict(ph)) for ph in want.phases]
