"""The same ``CentralManager`` schedule through the JAX package and the port.

Both managers back every page with real content (``data_plane_elems``),
use exact sampling and see the same numpy-made access counts, churn and
fault-injector seeds. After the run they must agree bit for bit on tiers,
owners, the frame table, queue counters, fault counters, FMMR and every
page's bytes. The port runs on ``device="cpu"``, where its data plane uses
the plain versions of the kernels.
"""
import numpy as np
import pytest
import torch

from repro.core.faults import FaultInjector as JaxFaultInjector
from repro.core.manager import CentralManager as JaxManager
from repro_torch.core.faults import FaultInjector as TorchFaultInjector
from repro_torch.core.faults import deep_validate
from repro_torch.core.manager import CentralManager as TorchManager

P, FAST, BUDGET, T, E = 512, 128, 32, 6, 37


def _schedule(make, injector, queue: bool):
    kw = dict(
        num_pages=P, fast_capacity=FAST, migration_budget=BUDGET, max_tenants=T,
        sample_period=100, exact_sampling=True, seed=7, data_plane_elems=E, sentinel=True,
    )
    if queue:
        kw.update(queue_size=64, migration_bandwidth=12, migration_latency=1)
    m = make(**kw)
    if injector is not None:
        m.set_fault_injector(injector)
    rng = np.random.default_rng(2024)
    handles, pages = [], []
    for n, t in ((140, 1.0), (120, 0.1), (100, 0.1), (60, 0.25)):
        h = m.register(t)
        handles.append(h)
        pages.append(m.allocate(h, n))
    content = rng.normal(size=(P, E)).astype(np.float32)
    owned = np.concatenate(pages)
    m.pool.write_pages(owned, content[owned])
    for e in range(10):
        counts = rng.integers(0, 30, P)
        hot = pages[1][: len(pages[1]) // 2]
        counts[hot] += 400
        counts[pages[2][:30]] += 250
        m.record_access(counts)
        m.run_epoch()
        if e == 4:  # churn: a tenant leaves, a newcomer takes its pages
            m.free(handles[3], pages[3][:40])
            m.unregister(handles[3])
            h = m.register(0.1)
            new = m.allocate(h, 50)
            m.pool.write_pages(new, content[new] * 2.0)
            content[new] *= 2.0
    m.run_epochs(4, counts=rng.integers(0, 50, (4, P)))
    return m


def _frames(m):
    return np.asarray(m.pool.frame)


def _pages_bytes(m):
    owned = np.flatnonzero(np.asarray(m.owners()) >= 0)
    pool = m.pool.pool
    rows = np.asarray(pool.cpu().numpy() if isinstance(pool, torch.Tensor) else pool)
    return owned, rows[_frames(m)[owned]]


@pytest.mark.parametrize("queue", [False, True])
@pytest.mark.parametrize("faults", [False, True])
def test_manager_schedule_matches_reference(queue, faults):
    def inj(cls):
        return cls(move_fail_rate=0.3, max_retries=1, seed=5) if faults else None

    jm = _schedule(JaxManager, inj(JaxFaultInjector), queue)
    tm = _schedule(lambda **kw: TorchManager(device="cpu", **kw), inj(TorchFaultInjector), queue)

    assert np.array_equal(tm.tiers(), np.asarray(jm.tiers()))
    assert np.array_equal(tm.owners().astype(np.int32), np.asarray(jm.owners()).astype(np.int32))
    assert np.array_equal(_frames(tm), _frames(jm))
    assert tm.queue_counters() == jm.queue_counters()
    assert tm.migration_failures == jm.migration_failures
    assert tm.pool.moved_pages == jm.pool.moved_pages
    if faults:
        assert tm.pool.fault_injector.counters() == jm.pool.fault_injector.counters()
    jf = np.asarray(jm.tenants.a_miss, np.float32)
    assert np.array_equal(tm.tenants.a_miss.numpy().view(np.int32), jf.view(np.int32))
    t_owned, t_bytes = _pages_bytes(tm)
    j_owned, j_bytes = _pages_bytes(jm)
    assert np.array_equal(t_owned, j_owned)
    assert np.array_equal(t_bytes.view(np.int32), j_bytes.view(np.int32))
    assert deep_validate(tm) == []
    if queue:
        c = tm.queue_counters()
        assert c["enqueued"] == c["drained"] + c["cancelled"] + c["dropped"] + c["depth"]


def test_pages_keep_their_bytes_through_migrations():
    """Every page reads back what was written, wherever it migrated."""
    m = TorchManager(num_pages=P, fast_capacity=FAST, migration_budget=BUDGET, max_tenants=T,
                     exact_sampling=True, queue_size=64, migration_bandwidth=16,
                     data_plane_elems=E, device="cpu")
    rng = np.random.default_rng(0)
    a, b = m.register(1.0), m.register(0.1)
    pa, pb = m.allocate(a, 200), m.allocate(b, 200)
    ids = np.concatenate([pa, pb])
    content = rng.normal(size=(len(ids), E)).astype(np.float32)
    m.pool.write_pages(ids, content)
    for _ in range(12):
        counts = np.zeros(P, np.int64)
        counts[pb] = rng.integers(100, 900, len(pb))
        m.record_access(counts)
        m.run_epoch()
    assert m.pool.moved_pages > 0
    got = m.pool.read_pages(ids).numpy()
    assert np.array_equal(got.view(np.int32), content.view(np.int32))
    m.pool.check(m.tiers())


def test_record_access_wraps_modulo_2_32():
    m = TorchManager(num_pages=8, fast_capacity=2, migration_budget=2, max_tenants=2,
                     device="cpu")
    m.record_access(np.full(8, 2**32 - 1, np.uint32))
    m.record_access(np.full(8, 3, np.int64))
    assert m._state.pending.tolist() == [2] * 8


@pytest.mark.parametrize("kind", ["tier", "nan"])
def test_sentinel_catches_poisoned_telemetry_like_reference(kind):
    """A poisoned cell raises the same sentinel bits in both packages."""
    out = []
    for make in (JaxManager, lambda **kw: TorchManager(device="cpu", **kw)):
        m = make(num_pages=64, fast_capacity=16, migration_budget=8, max_tenants=4,
                 exact_sampling=True, sentinel=True, queue_size=16)
        h = m.register(0.1)
        m.allocate(h, 40)
        m.record_access(np.arange(64) % 7)
        clean = int(m.run_epoch().stats.sentinel)
        m.poison_telemetry(kind)
        out.append((clean, int(m.run_epoch().stats.sentinel)))
    assert out[0] == out[1]
    assert out[1][0] == 0 and out[1][1] != 0


def test_control_surface_matches_reference():
    """Bandwidth, latency and sentinel changes mid-run; telemetry reads."""
    res = []
    for make in (JaxManager, lambda **kw: TorchManager(device="cpu", **kw)):
        m = make(num_pages=256, fast_capacity=64, migration_budget=16, max_tenants=4,
                 exact_sampling=True, queue_size=32, migration_bandwidth=4)
        a, b = m.register(1.0), m.register(0.1)
        m.allocate(a, 100)
        pb = m.allocate(b, 100)
        rng = np.random.default_rng(3)
        row = []
        for e in range(8):
            counts = rng.integers(0, 20, 256)
            counts[pb[:50]] += 300
            m.record_access(counts)
            m.run_epoch()
            if e == 2:
                m.set_migration_bandwidth(None)
                m.set_migration_latency(2)
            if e == 5:
                m.set_sentinel(True)
                m.set_target(b, 0.3)
            row.append((m.fast_pages_of(b), m.queue_depth(), m.migration_bounded,
                        m.tier_of(pb[:10]).tolist(), np.float32(m.fmmr_of(b)).item()))
        res.append((row, m.queue_counters()))
    assert res[0] == res[1]
