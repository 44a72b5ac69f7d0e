"""The port's fleet (``repro_torch.core.fleet``) against the reference's.

K machines whose knobs differ (seed, budget, bandwidth, latency, sample
period, EWMA lambda, hysteresis, fairness, bins, fast capacity and the four
storm guards) advance through one batched tick. With exact sampling the
port's ``FleetManager`` and the reference's give bit-equal telemetry,
plans, final states and queue counters on the same numpy counts, in
instant and queue mode. On the port alone, each fleet row equals its
machine run alone (sampled too: each machine draws its deviates from its
own generator), with plans and drained ids as padded prefixes;
``tests/golden/fleet_trace.json`` replays bit for bit; churn between
dispatches keeps parity, a clean dispatch uploads nothing, inert padding
rows never reach a result, machines of another shape or with a page pool
are refused, and no ``vmap`` batching-rule fallback occurs (its warning is
an error in this file).

Tolerance: none. Integer and float leaves are compared by their bits.
"""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

import golden_regen
from repro.core.fleet import FleetManager as JaxFleet
from repro.core.manager import CentralManager as JaxManager
from repro_torch.core.fleet import FleetManager
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import state_to_numpy

P, T, K, E = 1024, 8, 4, 6
BATCHING_RULE = ".*batching rule.*"


@pytest.fixture(autouse=True)
def _no_batching_fallback():
    """A ``vmap`` op without a batching rule falls back to a per-machine
    loop and warns; here that warning fails the test."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=BATCHING_RULE)
        yield


def _knobs(queue: bool):
    """Four machines that differ in every knob the fleet stacks."""
    out = []
    for s in range(K):
        kw = dict(
            seed=s, migration_budget=24 + 12 * s, fast_capacity=200 + 24 * s,
            sample_period=(1, 50, 100, 400)[s], ewma_lambda=(0.5, 0.3, 0.7, 0.45)[s],
            hysteresis=(0.08, 0.0, 0.15, 0.05)[s], fair_mode=bool(s % 2), num_bins=5 + s,
            promote_band=(-1.0, 0.12, 0.05, -1.0)[s], demote_band=(-1.0, 0.04, -1.0, 0.1)[s],
        )
        if queue:
            kw.update(queue_size=128, migration_bandwidth=8 + 8 * s, migration_latency=s % 2,
                      promote_admission=(None, 4, 16, 2)[s], demote_cooldown=(0, 2, 0, 3)[s])
        out.append(kw)
    return out


def _tenants(m):
    hs = []
    for t_miss, n in ((0.1, 300), (0.5, 300), (1.0, 200)):
        h = m.register(t_miss)
        m.allocate(h, n)
        hs.append(h)
    return hs


def _port(kw, exact=True):
    m = CentralManager(num_pages=P, max_tenants=T, exact_sampling=exact, device="cpu", **kw)
    return m, _tenants(m)


def _ref(kw):
    m = JaxManager(num_pages=P, max_tenants=T, exact_sampling=True, **kw)
    return m, _tenants(m)


def _counts(seed, shape, lam=4, scale=9):
    return (np.random.default_rng(seed).poisson(lam, shape) * scale).astype(np.int64)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits_equal(got, want, path):
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind == "f":
        assert np.array_equal(g.astype(w.dtype).view(np.int32), w.view(np.int32)), path
    else:
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), path


def _tree_equal(got, want, path):
    if want is None:
        assert got is None, path
        return
    if hasattr(want, "_fields"):
        for f in want._fields:
            if f != "rng":
                _tree_equal(getattr(got, f), getattr(want, f), f"{path}.{f}")
        return
    _bits_equal(got, want, path)


def _padded_prefix(fleet_ids, alone_ids, path):
    """A fleet's id lists are fleet-max wide: the machine's own list is a
    prefix and the rest is -1."""
    f, a = _np(fleet_ids), _np(alone_ids)
    np.testing.assert_array_equal(f[..., : a.shape[-1]], a, err_msg=path)
    assert (f[..., a.shape[-1]:] == -1).all(), path


# ------------------------------------------------------- port vs reference
@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_fleet_matches_reference(queue):
    knobs = _knobs(queue)
    counts = _counts(0, (K, E, P))
    ref = JaxFleet([_ref(kw)[0] for kw in knobs], devices=1)
    port = FleetManager([_port(kw)[0] for kw in knobs])
    want = ref.run_epochs(E, counts=counts, collect_plans=True)
    got = port.run_epochs(E, counts=counts, collect_plans=True)
    _tree_equal(got.stats, jax.device_get(want.stats), "stats")
    _tree_equal(got.plans, jax.device_get(want.plans), "plans")
    _bits_equal(got.flags, want.flags, "flags")
    for m in range(K):
        pm, rm = port.machines[m], ref.machines[m]
        _tree_equal(state_to_numpy(pm._state), jax.device_get(rm._state), f"state[{m}]")
        assert pm.queue_counters() == rm.queue_counters(), m
        assert pm.epoch_index == rm.epoch_index == E
    assert port.live_bytes() == ref.live_bytes()


# ---------------------------------------------------------- fleet == alone
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "sampled"])
@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_fleet_matches_each_machine_alone(queue, exact):
    knobs = _knobs(queue)
    counts = _counts(1, (K, E, P))
    fleet = FleetManager([_port(kw, exact)[0] for kw in knobs])
    res = fleet.run_epochs(E, counts=counts, collect_plans=True)
    for m, kw in enumerate(knobs):
        alone, _ = _port(kw, exact)
        want = alone.run_epochs(E, counts=counts[m], collect_plans=True)
        got = res.machine(m)
        q_got, q_want = got.stats.queue, want.stats.queue
        _tree_equal(got.stats._replace(queue=None), want.stats._replace(queue=None), "stats")
        if queue:
            for side in ("drained_promote_ids", "drained_demote_ids"):
                _padded_prefix(getattr(q_got, side), getattr(q_want, side), side)
            strip = dict(drained_promote_ids=None, drained_demote_ids=None)
            _tree_equal(q_got._replace(**strip), q_want._replace(**strip), "queue")
        for side in ("promote", "demote"):
            _padded_prefix(getattr(got.plans, side), getattr(want.plans, side), side)
        _bits_equal(got.flags, want.flags, "flags")
        _tree_equal(state_to_numpy(fleet.machines[m]._state), state_to_numpy(alone._state),
                    f"state[{m}]")
        assert fleet.machines[m].queue_counters() == alone.queue_counters()
    # each machine's generator advanced as it does alone
    if not exact:
        for m, kw in enumerate(knobs):
            alone, _ = _port(kw, exact)
            alone.run_epochs(E, counts=counts[m])
            assert torch.equal(fleet.machines[m]._state.rng.get_state(),
                               alone._state.rng.get_state())


def test_fleet_trace_replays_golden():
    """``tests/golden/fleet_trace.json`` (3 machines with their own seeds
    and budgets, exact sampling) on the port's fleet, bit for bit."""
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
    fleet = FleetManager(machines)
    counts = golden_regen.policy_counts()
    res = fleet.run_epochs(golden_regen.POLICY_EPOCHS,
                           counts=np.broadcast_to(counts, (len(fleet),) + counts.shape),
                           collect_plans=True)
    fresh = []
    for m in range(len(fleet)):
        records = res.machine(m).unstack()
        tier = fleet.machines[m].tiers()
        epochs = [golden_regen.epoch_record(r, tier) for r in records]
        for e in range(golden_regen.POLICY_EPOCHS - 1):
            epochs[e].pop("tier")
        fresh.append({"seed": golden_regen.FLEET_MACHINES[m][0],
                      "budget": golden_regen.FLEET_MACHINES[m][1], "epochs": epochs})
    assert json.loads(json.dumps(fresh)) == committed


# ------------------------------------------------------- dirty tracking
def test_churn_between_dispatches_and_clean_dispatch_uploads_nothing():
    """free / unregister / register / allocate between dispatches keep
    parity with the machines run alone; a dispatch with no control-plane
    operation since the last restacks nothing; a churned machine alone is
    uploaded into its row."""
    knobs = _knobs(queue=True)
    c1, c2, c3 = (_counts(s, (K, 4, P)) for s in (2, 3, 4))
    fleet_ms = [_port(kw) for kw in knobs]
    alone_ms = [_port(kw) for kw in knobs]
    fleet = FleetManager([m for m, _ in fleet_ms])

    def churn(i, m, hs):
        if i % 2 == 0:
            owned = np.flatnonzero(m.owners() == int(hs[1]))
            m.free(hs[1], owned)
            m.unregister(hs[1])
        else:
            m.allocate(m.register(0.3), 100)

    fleet.run_epochs(4, counts=c1)
    up = dict(fleet.upload_stats)
    assert up["restacked_machines"] == K
    fleet.run_epochs(4, counts=c1)
    assert fleet.upload_stats["restacked_machines"] == up["restacked_machines"]
    assert fleet.upload_stats["clean_dispatches"] == up["clean_dispatches"] + 1
    for i, (m, hs) in enumerate(fleet_ms):
        churn(i, m, hs)
    fleet.run_epochs(4, counts=c2)
    assert fleet.upload_stats["restacked_machines"] == 2 * K
    assert fleet.upload_stats["seg_rebuilds"] == 2 * K  # the first stack's, the churn's
    churn(1, *fleet_ms[1])  # one machine: its row alone goes up
    fleet.run_epochs(4, counts=c3)
    assert fleet.upload_stats["restacked_machines"] == 2 * K + 1
    assert fleet.upload_stats["seg_rebuilds"] == 2 * K + 1
    for i, (m, hs) in enumerate(alone_ms):
        m.run_epochs(4, counts=c1[i])
        m.run_epochs(4, counts=c1[i])
        churn(i, m, hs)
        m.run_epochs(4, counts=c2[i])
        if i == 1:
            churn(i, m, hs)
        m.run_epochs(4, counts=c3[i])
        f = fleet_ms[i][0]
        _tree_equal(state_to_numpy(f._state), state_to_numpy(m._state), f"state[{i}]")
        qc = f.queue_counters()
        assert qc == m.queue_counters()
        assert qc["enqueued"] == qc["drained"] + qc["cancelled"] + qc["dropped"] + qc["depth"]


def test_pad_to_rows_are_inert_and_dropped():
    knobs = _knobs(queue=True)[:3]
    counts = _counts(5, (3, E, P))
    plain = FleetManager([_port(kw, False)[0] for kw in knobs])
    padded = FleetManager([_port(kw, False)[0] for kw in knobs], pad_to=4)
    assert padded.num_padded == 4 and plain.num_padded == 3
    a = plain.run_epochs(E, counts=counts, collect_plans=True)
    b = padded.run_epochs(E, counts=counts, collect_plans=True)
    assert b.num_machines == 3 and b.flags.shape[0] == 3
    _tree_equal(b.stats, state_to_numpy_tree(a.stats), "stats")
    _tree_equal(b.plans, state_to_numpy_tree(a.plans), "plans")
    tier, owner = padded.stacked_placement()
    assert tier.shape == (3, P)
    for m in range(3):
        np.testing.assert_array_equal(tier[m], plain.machines[m].tiers())
    assert padded.live_bytes() * 3 == plain.live_bytes() * 4


def state_to_numpy_tree(tree):
    if tree is None or not hasattr(tree, "_fields"):
        return None if tree is None else _np(tree)
    return type(tree)(*(state_to_numpy_tree(x) for x in tree))


# ------------------------------------------------------------ refusals
def test_fleet_refuses_mismatched_shapes_pools_and_devices(monkeypatch):
    a, _ = _port(dict(seed=0, migration_budget=32, fast_capacity=256))

    def other(**kw):
        base = dict(num_pages=P, fast_capacity=256, migration_budget=32, max_tenants=T,
                    exact_sampling=True, device="cpu")
        return CentralManager(**{**base, **kw})

    for knob, kw in (("num_pages", dict(num_pages=2 * P)), ("max_tenants", dict(max_tenants=4)),
                     ("queue_size", dict(queue_size=64)),
                     ("exact_sampling", dict(exact_sampling=False))):
        with pytest.raises(ValueError, match=knob):
            FleetManager([a, other(**kw)])
    with pytest.raises(ValueError, match="pool"):
        FleetManager([a, other(data_plane_elems=4)])
    # two cards asked for where fewer are visible (the reference's
    # AssertionError at tests/test_fleet_sharded.py:141)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices"):
        FleetManager([a], devices=2)
    with pytest.raises(ValueError, match=r"\[K, P\]"):
        FleetManager([a]).run_epochs(2, counts=np.zeros((2, P), np.int64))


def test_no_batching_rule_fallback_on_the_tick():
    """Every op of the batched tick has a ``vmap`` batching rule: a dispatch
    run inline (on this thread) raises no fallback warning, and the
    searchsorted calls get contiguous values."""
    knobs = _knobs(queue=True)
    fleet = FleetManager([_port(kw, False)[0] for kw in knobs])
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        fleet.run_epochs_async(3, counts=_counts(6, (K, P)), collect_plans=True,
                               inline=True).result()
    texts = [str(w.message) for w in seen]
    assert not [t for t in texts if "batching rule" in t or "non-contiguous" in t], texts


@pytest.mark.parametrize("lam", [0.3, 0.45, 0.7])
def test_ewma_rounding_of_each_reference_program(lam):
    """The reference's single-epoch program and its k-epoch scan round the
    EWMA's two products differently (XLA fuses one of them into the add);
    at a lambda other than 0.5 the port's ``run_epoch`` follows the first
    and ``run_epochs`` (and the fleet) the second, bit for bit."""
    kw = dict(seed=3, migration_budget=40, fast_capacity=256, ewma_lambda=lam)
    counts = _counts(7, (E, P))
    (pa, _), (pb, _), (ra, _), (rb, _) = _port(kw), _port(kw), _ref(kw), _ref(kw)
    for e in range(E):
        pa.record_access(counts[e])
        ra.record_access(counts[e])
        _bits_equal(pa.run_epoch().stats.fmmr_ewma, ra.run_epoch().stats.fmmr_ewma, f"step {e}")
    got, want = pb.run_epochs(E, counts=counts), rb.run_epochs(E, counts=counts)
    _bits_equal(got.stats.fmmr_ewma, want.stats.fmmr_ewma, "scan")


@pytest.mark.parametrize("seed", [0, 2, 8])
def test_reallocation_scale_is_a_true_division(seed):
    """The tick scales the reallocation down by ``budget / moves`` with one
    float32 division, as the reference does (``python scalar / tensor`` in
    torch multiplies by the reciprocal instead: two roundings, and these
    states, found by search, then promote or demote one page more or less)."""
    import test_torch_tick as tick
    from repro.core import policy as jpolicy
    from repro_torch.core import policy as tpolicy
    from repro_torch.core.types import state_from_numpy

    Pn, Tn, budget = 512, 8, 30
    ref, fast_cap = tick.random_state(seed, Pn, Tn, 0, segs=True)
    jp, tp = tick.params_pair(fast_cap, budget, queue=False, guards=False)
    _, want_plan, want = jpolicy.epoch_step(tick._jax_state(ref), jp, max_tenants=Tn,
                                            plan_size=budget, exact_sampling=True)
    _, got_plan, got = tpolicy.epoch_step(state_from_numpy(ref, torch.device("cpu")), tp,
                                          max_tenants=Tn, plan_size=budget, exact_sampling=True)
    _tree_equal(got, jax.device_get(want), "stats")
    _tree_equal(got_plan, jax.device_get(want_plan), "plan")


@pytest.mark.parametrize("queue", [False, True], ids=["instant", "queue"])
def test_multi_epoch_trim_stats_matches_reference(queue):
    """``run_epochs``' tick with ``trim_stats``: the leaves the sweep never
    reads are dropped, the rest equal the reference's."""
    from repro.core import policy as jpolicy
    from repro_torch.core import policy as tpolicy

    kw = _knobs(queue)[1]
    (pm, _), (rm, _) = _port(kw), _ref(kw)
    pm._ensure_segs()
    rm._ensure_segs()
    counts = _counts(8, (3, P))
    got = tpolicy.multi_epoch(pm._state, pm.params, torch.as_tensor(counts), k=3, max_tenants=T,
                              plan_size=pm.plan_size, exact_sampling=True, trim_stats=True)
    want = jpolicy.multi_epoch(rm._state, rm.params, counts.astype(np.uint32), k=3,
                               max_tenants=T, plan_size=rm.plan_size, exact_sampling=True,
                               trim_stats=True)
    stats = got[2]
    assert stats.cooled is None and stats.slow_pages is None
    if queue:
        assert stats.queue.drained_promote_ids is None and stats.queue.drained_demote_ids is None
    _tree_equal(stats, jax.device_get(want[2]), "stats")
    _tree_equal(state_to_numpy(got[0]), jax.device_get(want[0]), "state")
