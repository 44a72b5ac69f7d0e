"""The plain model of the CUDA ``page_move``'s schedule (``ref.page_move_classes``,
``ref.page_move_phased_ref``) against gather semantics and the JAX package.

The card's kernel classifies each real entry (ids differ, both in range):
A (nobody reads its destination: copied in pass A), B (its source is never
written: copied in pass B) or S (staged through scratch). Here the plain
model runs the two passes entry by entry, in plan order and reversed, on
plans built with numpy from a seed: the data plane's demote/promote pairs
with trash padding, the KV cache's plans expanded over layers, swaps,
3-cycles, chains, an all-trash plan, an empty plan and out-of-range ids.
Tolerance: bit-equal (row copies are exact). Whole manager and serving
schedules on the CPU must plan no S entry. The kernel itself is held
against the same model on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _page_move_plans import FAMILIES, A, B, S
from repro.kernels import page_copy as jpc
from repro_torch.kernels import ops, ref

E = 37  # float32 elements per row: an odd width


def _plan(family, seed=0):
    rows, src, dst, want = FAMILIES[family](np.random.default_rng(seed))
    pool = np.random.default_rng(seed + 1).normal(size=(rows, E)).astype(np.float32)
    s = torch.as_tensor(np.asarray(src, np.int64).astype(np.int32))
    d = torch.as_tensor(np.asarray(dst, np.int64).astype(np.int32))
    return pool, s, d, np.asarray(want)


def _gather(pool_np, s, d):
    """Gather semantics on the in-range entries (``page_move_ref`` indexes
    with every id it is given)."""
    rows = pool_np.shape[0]
    keep = (s >= 0) & (s < rows) & (d >= 0) & (d < rows)
    return ref.page_move_ref(torch.as_tensor(pool_np.copy()), s[keep], d[keep])


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_page_move_classes(family):
    pool, s, d, want = _plan(family)
    got = ref.page_move_classes(s, d, pool.shape[0])
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_phased_model_keeps_gather_semantics(family, reverse):
    for seed in range(3):
        pool, s, d, _ = _plan(family, seed)
        got = ref.page_move_phased_ref(torch.as_tensor(pool.copy()), s, d, reverse=reverse)
        assert torch.equal(got.view(torch.int32), _gather(pool, s, d).view(torch.int32))


@pytest.mark.parametrize("family", ["dataplane", "kv", "chains", "all_trash", "mixed"])
def test_phased_model_matches_pallas(family):
    """The JAX package's Pallas ``page_move`` (interpret mode) on plans with
    in-range ids."""
    pool, s, d, _ = _plan(family, 5)
    want = jpc.page_move(jnp.asarray(pool), jnp.asarray(s.numpy()), jnp.asarray(d.numpy()))
    got = ref.page_move_phased_ref(torch.as_tensor(pool.copy()), s, d)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("family", ["swaps", "cycles3", "chains"])
def test_pallas_reads_pre_plan_rows_where_plan_order_differs(family):
    """On swaps, cycles and chains listed head first, reading the pool in
    plan order (as the reference's sequential grid would on one aliased
    buffer) differs from gather semantics. The reference's contract leaves
    such plans out ("a plan must never read a row it also writes"); in
    interpret mode its kernel reads the pre-plan rows, as the port does."""
    pool, s, d, _ = _plan(family, 6)
    if family == "chains":  # head first: each link reads the row the one before wrote
        order = np.argsort([0 if c == B else (2 if c == A else 1)
                            for c in ref.page_move_classes(s, d, pool.shape[0]).tolist()],
                           kind="stable")
        s, d = s[order], d[order]
    in_order = pool.copy()
    for i, j in zip(s.tolist(), d.tolist()):
        in_order[j] = in_order[i]
    gather = _gather(pool, s, d).numpy()
    assert not np.array_equal(in_order, gather)
    want = np.asarray(jpc.page_move(jnp.asarray(pool), jnp.asarray(s.numpy()),
                                    jnp.asarray(d.numpy())))
    assert np.array_equal(want.view(np.int32), gather.view(np.int32))
    got = ref.page_move_phased_ref(torch.as_tensor(pool.copy()), s, d)
    assert np.array_equal(got.numpy().view(np.int32), gather.view(np.int32))


def test_cpu_dispatch_is_the_gather():
    pool, s, d, _ = _plan("mixed", 2)
    got = ops.page_move(torch.as_tensor(pool.copy()), s, d)
    assert torch.equal(got, _gather(pool, s, d))


# ------------------------------------------- whole schedules plan no S entry
def _record_plans(monkeypatch):
    """Wrap ``ops.page_move``: every plan it is given is classified and run
    through the phased model, which must match the gather it replaces."""
    seen = []
    inner = ops.page_move

    def page_move(pool, src, dst):
        cls = ref.page_move_classes(src, dst, pool.shape[0])
        seen.append(torch.bincount(cls, minlength=4).tolist())
        phased = ref.page_move_phased_ref(pool.clone(), src, dst, reverse=True)
        out = inner(pool, src, dst)
        assert torch.equal(out, phased)
        return out

    monkeypatch.setattr(ops, "page_move", page_move)
    return seen


@pytest.mark.parametrize("queue", [False, True])
def test_data_plane_schedule_plans_no_staged_entry(monkeypatch, queue):
    """A manager schedule with churn and fault injection, as
    tests/test_torch_manager.py runs it."""
    from repro_torch.core.faults import FaultInjector
    from repro_torch.core.manager import CentralManager

    seen = _record_plans(monkeypatch)
    P, Ep = 512, 37
    kw = dict(num_pages=P, fast_capacity=128, migration_budget=32, max_tenants=6,
              sample_period=100, exact_sampling=True, seed=7, data_plane_elems=Ep,
              sentinel=True, device="cpu")
    if queue:
        kw.update(queue_size=64, migration_bandwidth=12, migration_latency=1)
    m = CentralManager(**kw)
    m.set_fault_injector(FaultInjector(move_fail_rate=0.3, max_retries=1, seed=5))
    rng = np.random.default_rng(2024)
    handles, pages = [], []
    for n, t in ((140, 1.0), (120, 0.1), (100, 0.1), (60, 0.25)):
        handles.append(m.register(t))
        pages.append(m.allocate(handles[-1], n))
    for e in range(12):
        counts = rng.integers(0, 30, P)
        counts[pages[1][: 60 if e < 6 else 20]] += 400
        counts[pages[2][e * 5 : e * 5 + 30]] += 250
        m.record_access(counts)
        m.run_epoch()
        if e == 4:
            m.free(handles[3], pages[3][:40])
            m.unregister(handles[3])
            m.allocate(m.register(0.1), 50)
    m.run_epochs(4, counts=rng.integers(0, 50, (4, P)))
    totals = np.sum(seen, axis=0)
    assert len(seen) > 0 and totals[S] == 0
    assert totals[A] > 0 and totals[B] > 0  # demotes, and promotes into vacated frames


def test_kv_cache_schedule_plans_no_staged_entry(monkeypatch):
    """An engine run on the CPU at ``.smoke()`` size, as
    tests/test_torch_serving.py drives it: every migrating epoch's four
    ``page_move`` calls."""
    from repro_torch.configs import get_config
    from repro_torch.core.manager import CentralManager
    from repro_torch.kvcache.paged import TieredPagedKV
    from repro_torch.models.model import get_model
    from repro_torch.serving.driver import OpenLoopDriver, TenantSpec
    from repro_torch.serving.engine import ServingEngine

    seen = _record_plans(monkeypatch)
    cfg = get_config("yi-6b").smoke()
    fast, slow = 16, 80
    m = CentralManager(num_pages=fast + slow, fast_capacity=fast, migration_budget=8,
                       max_tenants=4, sample_period=1, exact_sampling=True, queue_size=32,
                       migration_bandwidth=8, alloc_headroom=6, device="cpu")
    eng = ServingEngine(cfg, get_model(cfg).init(seed=0, device="cpu"), m,
                        TieredPagedKV(cfg, fast, slow, page_tokens=4, device="cpu"),
                        max_batch=4, pages_per_seq=8, quest_pages=2, epoch_steps=2)
    OpenLoopDriver(eng, [TenantSpec("ls", 0.1, 0.10, 12, 16),
                         TenantSpec("be", 1.0, 0.15, 16, 24)], seed=7).run(64)
    totals = np.sum(seen, axis=0)
    assert len(seen) > 0 and len(seen) % 4 == 0 and totals[S] == 0
    assert totals[A] > 0
