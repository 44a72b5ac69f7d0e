"""The port's spans (``repro_torch.runtime.spans``) and counters on the
benchmark cell's manager cut to 16,384 pages (queue mode, a page pool):

  * under ``torch.profiler`` the epoch records its documented spans, and
    every operation inside ``maxmem.tick`` lies in exactly one stage span;
    the three ``scatter_add`` sites fall in three different stages;
  * the profiler changes nothing: tiers, FMMR bits, queue counters, the
    sentinel words and every state leaf equal a run without it; the
    fleet's vmapped tick too, with no batching-rule fallback;
  * ``CentralManager.device_reads`` counts each path's blocking reads;
  * ``PagePool.launched_slots`` is calls x ``plan_slots``.
"""
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from perfbench import trace
from perfbench.systems.manager import System
from perfbench.tests.test_perfbench_kvs import small_cell
from repro_torch.core.fleet import FleetManager
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import state_to_numpy
from repro_torch.kernels import ops
from repro_torch.runtime import spans

SEED = 2**31 + 4242
STAGES = {"tick.sample", "tick.queue", "tick.sums", "tick.bins", "tick.fmmr", "tick.hist",
          "tick.victims", "tick.sentinel"}
EPOCH_SPANS = STAGES | {"record", "epoch", "tick", "epoch.sync", "dataplane", "dataplane.plan",
                        "dataplane.upload", "dataplane.launch", "epoch.stats"}


def built() -> System:
    cell = small_cell()
    sut = System(cell["config"], cell["traffic"], SEED, "cpu")
    sut.setup()
    return sut


def cpu_events(prof):
    """(name, start_ns, end_ns) of the profile's host events."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def intervals(events, name):
    return [(s, e) for n, s, e in events if n == spans.PREFIX + name]


def inside(iv, s, e):
    return any(a <= s and e <= b for a, b in iv)


def epochs_until_a_move(sut, most=12):
    """Epochs until one moved pages, so that every data-plane span ran."""
    for _ in range(most):
        before = sut.m.pool.moved_pages
        sut._epoch()
        if sut.m.pool.moved_pages > before:
            return
    raise AssertionError(f"no page moved in {most} epochs")


def test_spans_cover_the_tick_stage_by_stage():
    sut = built()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        epochs_until_a_move(sut)
    ev = cpu_events(prof)
    names = {n[len(spans.PREFIX):] for n, _, _ in ev if n.startswith(spans.PREFIX)}
    assert names == EPOCH_SPANS
    ticks = intervals(ev, "tick")
    epochs = intervals(ev, "epoch")
    assert ticks and all(inside(epochs, s, e) for s, e in ticks)
    for name in EPOCH_SPANS - {"record", "epoch"}:
        assert all(inside(epochs, s, e) for s, e in intervals(ev, name)), name
    stage_iv = {st: intervals(ev, st) for st in STAGES}
    for st, iv in stage_iv.items():
        assert all(inside(ticks, s, e) for s, e in iv), st
    scatters = set()
    n_ops = 0
    for n, s, e in ev:
        if not n.startswith("aten::") or not inside(ticks, s, e):
            continue
        n_ops += 1
        holders = [st for st, iv in stage_iv.items() if inside(iv, s, e)]
        assert len(holders) == 1, (n, holders)
        if n == "aten::scatter_add":
            scatters.add(holders[0])
    assert n_ops > 100
    assert scatters == {"tick.sums", "tick.bins", "tick.hist"}


def _final(sut):
    m = sut.m
    return {
        "tiers": m.tiers().copy(),
        "fmmr_bits": m.tenants.a_miss.detach().cpu().numpy().view(np.int32).copy(),
        "counters": m.queue_counters(),
        "sentinel": [int(x) for x in sut.sentinel],
        "moved": [(int(a), int(b)) for a, b in sut.moved],
        "frames": np.asarray(m.pool.frame).copy(),
        "state": state_to_numpy(m._state),
    }


def _assert_same(a, b, path="run"):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


def test_the_profiler_changes_nothing():
    plain, profiled = built(), built()
    for _ in range(6):
        plain._epoch()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(6):
            profiled._epoch()
    _assert_same(_final(plain), _final(profiled))


def _fleet():
    ms = []
    for s in range(2):
        m = CentralManager(num_pages=2048, fast_capacity=400, migration_budget=32, max_tenants=4,
                           queue_size=64, migration_bandwidth=12, seed=s, device="cpu")
        for t_miss, n in ((0.1, 900), (1.0, 900)):
            m.allocate(m.register(t_miss), n)
        ms.append(m)
    return FleetManager(ms)


def test_the_fleets_vmapped_tick_under_the_profiler():
    counts = (np.random.default_rng(7).poisson(3, (2, 4, 2048)) * 11).astype(np.int64)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        plain = _fleet()
        want = plain.run_epochs(4, counts=counts, collect_plans=True)
        profiled = _fleet()
        # inline: a profiler sees only the threads it was started on, and
        # the fleet dispatches on a thread of its own
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = profiled.run_epochs_async(4, counts=counts, collect_plans=True,
                                            inline=True).result()
    names = {n for n, _, _ in cpu_events(prof)}
    assert {spans.PREFIX + st for st in STAGES} <= names
    for a, b in zip(plain.machines, profiled.machines):
        _assert_same(state_to_numpy(a._state), state_to_numpy(b._state), "state")
        assert a.queue_counters() == b.queue_counters()
    _assert_same(want.flags, got.flags, "flags")
    for f in want.stats._fields:
        x, y = getattr(want.stats, f), getattr(got.stats, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f


def _free_some(m):
    ids = np.flatnonzero(m.owners() == 0)[:8]
    m.free(0, ids)
    m.owners()  # the snapshot, cached again
    return ids


# each path and its blocking reads of the manager's state
READ_PATHS = {
    # 2 drained-id copies, 4 queue counters, 1 flags
    "run_epoch": (lambda m: None, lambda m, _: m.run_epoch(), 7),
    # the same, once for the k epochs
    "run_epochs": (lambda m: None, lambda m, _: m.run_epochs(3), 7),
    # tiers() takes the snapshot (2), owners() reuses it; queue_depth, fmmr_of
    "telemetry": (lambda m: setattr(m, "_snap", None),
                  lambda m, _: (m.tiers(), m.owners(), m.queue_depth(), m.fmmr_of(0)), 4),
    # register: the active slots; allocate: the new owner for the segments
    # (the snapshot is cached)
    "allocate": (_free_some, lambda m, _: m.allocate(m.register(0.5), 8), 2),
    # count, last_cool, the new owner, pending, the queue's page and direction
    "free": (lambda m: np.flatnonzero(m.owners() == 0)[:8],
             lambda m, ids: m.free(0, ids), 6),
}


@pytest.mark.parametrize("path", sorted(READ_PATHS))
def test_device_reads_counts_each_blocking_read(path):
    sut = built()
    m = sut.m
    m.record_access(sut.cycle[0])
    prepare, act, reads = READ_PATHS[path]
    arg = prepare(m)
    r0 = m.device_reads
    act(m, arg)
    assert m.device_reads - r0 == reads


def test_launched_slots_is_calls_times_the_plan():
    sut = built()
    pool = sut.m.pool
    calls = []

    def counting(orig):
        def move(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)
        return move

    s0, m0 = pool.launched_slots, pool.moved_pages
    with trace.patched(ops, "page_move", counting):
        epochs_until_a_move(sut)
        for _ in range(3):
            sut._epoch()
    assert calls
    assert pool.launched_slots - s0 == len(calls) * pool.plan_slots
    assert 0 < pool.moved_pages - m0 <= pool.launched_slots - s0


def test_a_span_is_a_range_only_while_profiled():
    assert spans.span("x") is spans._OFF
    seconds = {"x": 0.0}
    with spans.span("x", seconds, "x"):
        sum(range(1000))
    assert seconds["x"] > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("x"):
            torch.ones(3).add_(1)
    assert [n for n, _, _ in cpu_events(prof) if n.startswith(spans.PREFIX)] == ["maxmem.x"]


@pytest.mark.cuda
def test_spans_leave_the_benchmarks_trace_reading_unchanged_on_the_card():
    """On the card a span is a host event only: the profile holds no
    device-side event of the program's, and the benchmark's reduction reads
    the same with every program event dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from types import SimpleNamespace

    cell = small_cell()
    sut = System(cell["config"], cell["traffic"], SEED, "cuda")
    sut.setup()
    got, out = {}, {}

    def keeping(reduce):
        def keep(prof, wall):
            got["prof"], got["wall"] = prof, wall
            return reduce(prof, wall)
        return keep

    with trace.patched(trace, "reduce", keeping), sut.instrument(), trace.traced(out):
        epochs_until_a_move(sut)
    events = list(got["prof"].profiler.kineto_results.events())
    ours = [e for e in events if e.name().startswith(spans.PREFIX)]
    assert {e.name()[len(spans.PREFIX):] for e in ours} == EPOCH_SPANS
    assert all(e.device_type() == DeviceType.CPU for e in ours)
    kept = [e for e in events if not e.name().startswith(spans.PREFIX)]
    bare = trace.reduce(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: kept))), got["wall"])
    full = out["trace"]
    assert full.ops == bare.ops and full.ranges == bare.ranges
    assert full.busy_s == bare.busy_s and full.breakdown() == bare.breakdown()
