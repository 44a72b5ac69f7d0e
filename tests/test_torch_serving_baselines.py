"""The port's serving placement baselines against the JAX package on the CPU:
``FixedPartitionManager``'s first-touch allocation inside a tenant's quota,
``make_serving_manager``'s three modes, and the three legs of
``benchmarks/serving_colocation.py`` (maxmem, static, fixed) at that
benchmark's own machine, tenants and seed on yi-6b smoke, whose reports
(migrated pages, modeled latency percentiles, per-tenant fast pages) must
be equal. The legs run fewer steps than the benchmark's 24 + 60 to keep the
file short; the comparison is exact, so the length changes nothing but the
reach.
"""
import jax
import numpy as np
import pytest

from benchmarks import serving_colocation as bench
from repro.configs import get_config as jax_config
from repro.core.types import TIER_FAST
from repro.kvcache.paged import TieredPagedKV as JaxKV
from repro.models.model import get_model as jax_model
from repro.serving.baselines import FixedPartitionManager as JaxFixed
from repro.serving.baselines import make_serving_manager as jax_make_manager
from repro.serving.driver import OpenLoopDriver as JaxDriver
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import state_to_numpy
from repro_torch.kvcache.paged import TieredPagedKV
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.baselines import FixedPartitionManager, make_serving_manager
from repro_torch.serving.driver import OpenLoopDriver, TenantSpec
from repro_torch.serving.engine import ServingEngine

LEG_STEPS = 36
MACHINE = dict(num_pages=bench.FAST_PAGES + bench.SLOW_PAGES, fast_capacity=bench.FAST_PAGES,
               migration_budget=bench.BANDWIDTH, queue_size=bench.QUEUE_SIZE,
               migration_bandwidth=bench.BANDWIDTH,
               fast_quota={"ls": bench.FAST_PAGES // 2, "be": bench.FAST_PAGES // 2},
               alloc_headroom=bench.ALLOC_HEADROOM, max_tenants=4)


def _states_equal(tm, jm):
    ts, js = state_to_numpy(tm._state), jm._state
    for part in ("pages", "tenants", "queue"):
        for name, t_leaf in getattr(ts, part)._asdict().items():
            j_leaf = np.asarray(getattr(getattr(js, part), name))
            assert np.array_equal(t_leaf, j_leaf.astype(t_leaf.dtype)), (part, name)


# ------------------------------------------------------------ the fixed partition
def test_fixed_partition_allocate_matches_reference():
    kw = dict(num_pages=24, fast_capacity=8, migration_budget=0, max_tenants=4,
              sample_period=1, exact_sampling=True, queue_size=8, migration_bandwidth=0)
    jm, tm = JaxFixed(**kw), FixedPartitionManager(device="cpu", **kw)
    for m in (jm, tm):
        m.register_with_quota(0.1, 3)
        m.register_with_quota(1.0, 6)
        m.register(0.5)  # no quota: slow only
    schedule = [(0, 2), (1, 4), (0, 3), (2, 2), (1, 3), (0, 1), (2, 3)]
    for h, n in schedule:
        pj = np.asarray(jm.allocate(h, n))
        pt = tm.allocate(h, n)
        assert np.array_equal(pt, pj)
        _states_equal(tm, jm)
    tiers, owners = tm.tiers(), tm.owners()
    fast_of = [int(((owners == h) & (tiers == TIER_FAST)).sum()) for h in range(3)]
    assert fast_of == [3, 5, 0]  # 3 of quota 3; 5 of quota 6 (fast tier full: 8)
    tm.free(1, np.flatnonzero(owners == 1)[:2])
    jm.free(1, np.flatnonzero(np.asarray(jm.pages.owner) == 1)[:2])
    assert np.array_equal(tm.allocate(1, 2), np.asarray(jm.allocate(1, 2)))
    _states_equal(tm, jm)
    for m in (jm, tm):
        with pytest.raises(MemoryError, match="out of tiered memory"):
            m.allocate(0, 24)


def test_make_serving_manager_modes():
    for mode in ("maxmem", "static", "fixed"):
        m = make_serving_manager(mode, device="cpu", **MACHINE)
        assert isinstance(m, CentralManager)
        bw = int(m.params.migration_bandwidth)
        assert bw == (bench.BANDWIDTH if mode == "maxmem" else 0)
        assert int(m.params.alloc_headroom) == (bench.ALLOC_HEADROOM if mode == "maxmem" else 0)
        assert (m.num_pages, m.max_tenants, m.queue_size, m.plan_size) == (96, 4, 32, 8)
    fixed = make_serving_manager("fixed", device="cpu", **MACHINE)
    assert isinstance(fixed, FixedPartitionManager) and fixed.named_quota == {"ls": 8, "be": 8}
    for bad in ("hemem", "", "MAXMEM"):
        with pytest.raises(ValueError, match="unknown serving manager mode"):
            make_serving_manager(bad, device="cpu", **MACHINE)


def test_driver_resolves_named_quotas():
    cfg = get_config("yi-6b").smoke()
    m = make_serving_manager("fixed", device="cpu", **MACHINE)
    kv = TieredPagedKV(cfg, bench.FAST_PAGES, bench.SLOW_PAGES, page_tokens=4, device="cpu")
    eng = ServingEngine(cfg, None, m, kv)
    OpenLoopDriver(eng, [TenantSpec(*t.__dict__.values()) for t in bench.TENANTS])
    assert m.fast_quota == {int(eng.tenant_handles["ls"]): 8, int(eng.tenant_handles["be"]): 8}


# ------------------------------------------------------------ the three legs
@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("yi-6b").smoke()
    tcfg = get_config("yi-6b").smoke()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, jax.device_get(jparams), "cpu")


def _leg(mode, cfg, params, port: bool, manager=None):
    """One leg as ``serving_colocation._engine`` builds it (on the port,
    with ``manager`` in place of ``make_serving_manager``'s if given)."""
    ekw = dict(max_batch=bench.MAX_BATCH, pages_per_seq=bench.PAGES_PER_SEQ, quest_pages=2,
               epoch_steps=bench.EPOCH_STEPS)
    if port:
        m = manager or make_serving_manager(mode, device="cpu", **MACHINE)
        kv = TieredPagedKV(cfg, bench.FAST_PAGES, bench.SLOW_PAGES,
                           page_tokens=bench.PAGE_TOKENS, device="cpu")
        eng = ServingEngine(cfg, params, m, kv, **ekw)
        drv = OpenLoopDriver(eng, [TenantSpec(*t.__dict__.values()) for t in bench.TENANTS],
                             seed=7)
    else:
        m = jax_make_manager(mode, **MACHINE)
        kv = JaxKV(cfg, bench.FAST_PAGES, bench.SLOW_PAGES, page_tokens=bench.PAGE_TOKENS)
        eng = JaxEngine(cfg, params, m, kv, **ekw)
        drv = JaxDriver(eng, bench.TENANTS, seed=7)
    return eng, drv.run(LEG_STEPS)


@pytest.mark.parametrize("mode", bench.MODES)
def test_colocation_leg_matches_reference(models, mode):
    jcfg, tcfg, jparams, tparams = models
    je, jrep = _leg(mode, jcfg, jparams, port=False)
    te, trep = _leg(mode, tcfg, tparams, port=True)
    assert trep == jrep  # migrated pages, modeled latency percentiles, completions
    assert te._epoch_log == je._epoch_log
    _states_equal(te.manager, je.manager)
    owners, tiers = te.manager.owners(), te.manager.tiers()
    j_owner, j_tier = np.asarray(je.manager.pages.owner), np.asarray(je.manager.pages.tier)
    for name, h in te.tenant_handles.items():
        fast = int(((owners == int(h)) & (tiers == TIER_FAST)).sum())
        assert fast == int(((j_owner == int(h)) & (j_tier == TIER_FAST)).sum()), name
        if mode == "fixed":
            assert fast <= MACHINE["fast_quota"][name]
    moved = trep["_engine"]["migrated_pages"]
    assert (moved > 0) if mode == "maxmem" else (moved == 0)
    assert trep["ls"]["latency"] and trep["be"]["latency"]


def test_named_quota_set_after_construction_gives_the_same_fixed_leg(models):
    """The reference's ``make_serving_manager`` builds the fixed manager and
    then sets ``_named_quota``; done that way on the port, the driver
    resolves the same quotas and the leg is the same."""
    _, tcfg, _, tparams = models
    kw = {k: v for k, v in MACHINE.items()
          if k not in ("fast_quota", "alloc_headroom", "migration_bandwidth")}
    m = FixedPartitionManager(migration_bandwidth=0, sample_period=1, exact_sampling=True,
                              device="cpu", **kw)
    m._named_quota = dict(MACHINE["fast_quota"])
    assert m.named_quota == MACHINE["fast_quota"] and m._named_quota is m.named_quota
    late, late_rep = _leg("fixed", tcfg, tparams, port=True, manager=m)
    ctor, ctor_rep = _leg("fixed", tcfg, tparams, port=True)
    assert late.manager.fast_quota == ctor.manager.fast_quota != {}
    assert late_rep == ctor_rep
    assert late._epoch_log == ctor._epoch_log
    assert np.array_equal(late.manager.tiers(), ctor.manager.tiers())
    assert np.array_equal(late.manager.owners(), ctor.manager.owners())
