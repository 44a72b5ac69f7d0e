"""The port's MoE expert-weight tiering against the JAX package on the CPU.

The reference's own tests (``tests/test_expert_tiering.py``) run against
the port; then both packages take the same routing-count sequence and must
end with equal slot maps, migration counts, unpaired counters, manager
state and pools (bit for bit: the pools only move rows). Every expert plan
is a set of paired swaps, so every entry reads a row the plan also writes:
``page_move`` stages all of them (class S). ``moe_layer_from_pools`` agrees
with the reference within 1e-5 in float32, and within 1e-5 with bf16
weights and float32 tokens (both promote the products to float32), its
expert counts exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.types import MigrationPlan as JaxPlan
from repro.models.model import get_model as jax_model
from repro.serving.expert_tiering import ExpertTierManager as JaxTierManager
from repro.serving.expert_tiering import moe_layer_from_pools as jax_layer_from_pools
from repro_torch.configs import get_config
from repro_torch.core.types import MigrationPlan, state_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import get_model
from repro_torch.serving.expert_tiering import ExpertTierManager, moe_layer_from_pools

OUT_TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-moe-a2.7b").smoke()
    return cfg, get_model(cfg).init(seed=0, device="cpu")


@pytest.fixture(scope="module")
def both():
    jcfg = jax_config("qwen2-moe-a2.7b").smoke()
    tcfg = get_config("qwen2-moe-a2.7b").smoke()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(tcfg, jax.device_get(jparams), "cpu")


def _router(params, l):
    return params["layers"]["moe"]["router"][l]


def _tier(cfg, params, **kw):
    tm = ExpertTierManager(cfg, device="cpu", **kw)
    tm.build_pools(params)
    return tm


# ------------------------------------------- the reference's tests, on the port
def test_pools_roundtrip_and_forward_consistency(setup):
    cfg, params = setup
    E = cfg.num_experts
    tm = _tier(cfg, params, n_fast_slots=4, migration_budget=6, epoch_steps=2)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(6, cfg.d_model)).astype(np.float32))
    slots0 = tm.slot_table()[0]
    out_before, counts = moe_layer_from_pools(tm.pools, slots0, _router(params, 0), x, cfg=cfg)
    assert int(counts.sum()) == 6 * cfg.moe_top_k
    rng = np.random.default_rng(0)
    L = cfg.num_layers
    moved_total = 0
    for _ in range(12):
        ec = np.zeros((L, E), np.int64)
        ec[:, :2] = 50
        ec[:, 2:] = rng.integers(0, 3, (L, E - 2))
        tm.record_routing(ec)
        moved_total += tm.maybe_epoch()
    assert moved_total > 0, "no expert migrations happened"
    slots1 = tm.slot_table()[0]
    assert not torch.equal(slots0, slots1)
    out_after, _ = moe_layer_from_pools(tm.pools, slots1, _router(params, 0), x, cfg=cfg)
    assert torch.equal(out_before, out_after)  # the same rows, the same products


def test_hot_experts_become_fast_resident(setup):
    cfg, params = setup
    E, L = cfg.num_experts, cfg.num_layers
    tm = _tier(cfg, params, n_fast_slots=L * 2, migration_budget=8, epoch_steps=1, t_miss=0.2)
    rng = np.random.default_rng(1)
    ec = np.zeros((L, E), np.int64)
    for _ in range(30):
        ec[:] = 0
        ec[:, 0] = 80
        ec[:, 1] = 40
        ec[:, 2:] = rng.integers(0, 2, (L, E - 2))
        tm.record_routing(ec)
        tm.maybe_epoch()
    hot_resident = np.mean([tm.fast_resident(l, 0) for l in range(L)])
    assert hot_resident > 0.8, f"hot expert fast-residency only {hot_resident:.0%}"
    assert tm.fast_share_of_traffic(ec) > 0.6
    assert tm.fmmr() < 0.5


def test_odd_plan_remainder_counted_not_dropped(setup):
    cfg, params = setup
    tm = _tier(cfg, params, n_fast_slots=4, migration_budget=8, epoch_steps=1)
    plan = MigrationPlan(promote=torch.tensor([4, 5, 6, -1]), demote=torch.tensor([0, -1, -1, -1]))
    before = {p: tm.pools.w_gate[tm.slot_of[p]].clone() for p in (0, 4, 5, 6)}
    moved = tm._migrate(plan)
    assert moved == 2, "one executable pair = two page moves"
    assert tm.unpaired_promotes == 2 and tm.unpaired_demotes == 0
    assert int(tm.slot_of[4]) == 0 and int(tm.slot_of[0]) == 4
    assert int(tm.slot_of[5]) == 5 and int(tm.slot_of[6]) == 6
    for p in (0, 4, 5, 6):
        assert torch.equal(before[p], tm.pools.w_gate[tm.slot_of[p]])


def test_real_router_skew_from_moe_model(setup):
    cfg, params = setup
    E, L = cfg.num_experts, cfg.num_layers
    tm = _tier(cfg, params, n_fast_slots=L * 3, migration_budget=8, epoch_steps=2, t_miss=0.3)
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(16, cfg.d_model)).astype(np.float32))
    for _ in range(10):
        counts = torch.stack([
            moe_layer_from_pools(tm.pools, tm.slot_table()[l], _router(params, l), x, cfg=cfg)[1]
            for l in range(L)])
        tm.record_routing(counts)
        tm.maybe_epoch()
    share = tm.fast_share_of_traffic(counts)
    assert share >= 3 / E - 0.05, f"fast traffic share {share:.2f}"


# ------------------------------------------- against the reference
def _routing_sequence(L, E, steps, seed):
    """Skewed counts whose hot experts drift, so plans keep coming."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        ec = rng.integers(0, 4, (L, E)).astype(np.int64)
        hot = (np.arange(L)[:, None] + s // 6 + np.arange(2)[None, :]) % E
        np.put_along_axis(ec, hot, 60 + rng.integers(0, 20, (L, 2)), axis=1)
        out.append(ec)
    return out


def test_tiering_run_matches_reference(both, monkeypatch):
    """The same routing counts through both managers: slot maps, moves,
    unpaired counters, manager state and pools equal; every plan all S."""
    jcfg, tcfg, jparams, tparams = both
    kw = dict(n_fast_slots=5, migration_budget=4, epoch_steps=2, t_miss=0.2)
    jt = JaxTierManager(jcfg, **kw)
    jt.build_pools(jparams)
    tt = _tier(tcfg, tparams, **kw)
    plans = []
    inner = ops.page_move
    monkeypatch.setattr(ops, "page_move",
                        lambda pool, s, d: plans.append((s.clone(), d.clone(), pool.shape[0]))
                        or inner(pool, s, d))
    moved_j = moved_t = migrating = 0
    L, E = tcfg.num_layers, tcfg.num_experts
    for ec in _routing_sequence(L, E, 24, seed=5):
        jt.record_routing(ec)
        tt.record_routing(ec)
        mj, mt = jt.maybe_epoch(), tt.maybe_epoch()
        assert mt == mj
        moved_j, moved_t = moved_j + mj, moved_t + mt
        migrating += mt > 0
        assert np.array_equal(tt.slot_of, jt.slot_of)
    assert moved_t == moved_j > 0
    assert (tt.unpaired_promotes, tt.unpaired_demotes) == (jt.unpaired_promotes,
                                                           jt.unpaired_demotes)
    assert np.array_equal(tt.slot_table().numpy(), np.asarray(jt.slot_table()))
    ts = state_to_numpy(tt.manager._state)
    js = jt.manager._state
    for part in ("pages", "tenants"):
        for name, t_leaf in getattr(ts, part)._asdict().items():
            j_leaf = np.asarray(getattr(getattr(js, part), name))
            assert np.array_equal(t_leaf, j_leaf.astype(t_leaf.dtype)), (part, name)
    assert tt.fmmr() == pytest.approx(jt.fmmr(), abs=0)
    for t, j in zip(tt.pools, jt.pools):
        assert np.array_equal(t.numpy(), np.asarray(j))
    # three pools per migrating epoch, each plan a set of swaps: all staged
    assert len(plans) == 3 * migrating
    for s, d, rows in plans:
        cls = ref.page_move_classes(s, d, rows)
        assert bool((cls == ref.MOVE_S).all()), cls
        assert sorted(s.tolist()) == sorted(d.tolist())


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_moe_layer_from_pools_matches_reference(both, wdtype):
    """Float32 tokens through pools of float32 or bf16 weights: the output
    within 1e-5 (JAX promotes the bf16 products to float32; so does the
    port), the expert counts exactly; after migrations on both sides too."""
    jcfg, tcfg, jparams, tparams = both
    if wdtype == "bfloat16":
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
        tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
        jparams = jax_model(jcfg).init(jax.random.PRNGKey(2))
        tparams = params_from_numpy(tcfg, jax.device_get(jparams), "cpu")
        assert tparams["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    kw = dict(n_fast_slots=6, migration_budget=6, epoch_steps=1)
    jt = JaxTierManager(jcfg, **kw)
    jt.build_pools(jparams)
    tt = _tier(tcfg, tparams, **kw)
    x = np.random.default_rng(6).normal(size=(12, tcfg.d_model)).astype(np.float32)
    L = tcfg.num_layers
    for ec in [None] + _routing_sequence(L, tcfg.num_experts, 3, seed=7):
        if ec is not None:
            for t in (jt, tt):
                t.record_routing(ec)
                t.maybe_epoch()
        for l in range(L):
            jo, jc = jax_layer_from_pools(jt.pools, jt.slot_table()[l],
                                          jparams["layers"]["moe"]["router"][l],
                                          jnp.asarray(x), cfg=jcfg)
            to, tc = moe_layer_from_pools(tt.pools, tt.slot_table()[l],
                                          _router(tparams, l), torch.as_tensor(x), cfg=tcfg)
            assert to.dtype == torch.float32 and np.asarray(jo).dtype == np.float32
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OUT_TOL, rtol=OUT_TOL)
            assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tt.slot_of, jt.slot_of) and not np.array_equal(
        tt.slot_of, np.arange(tt.n_slots))


def test_migrate_plans_match_reference_on_a_given_plan(both):
    jcfg, tcfg, jparams, tparams = both
    jt = JaxTierManager(jcfg, n_fast_slots=4, migration_budget=8, epoch_steps=1)
    jt.build_pools(jparams)
    tt = _tier(tcfg, tparams, n_fast_slots=4, migration_budget=8, epoch_steps=1)
    promote, demote = [9, 4, 17, 5, -1], [0, 2, -1, -1, -1]
    mj = jt._migrate(JaxPlan(promote=jnp.asarray(promote), demote=jnp.asarray(demote)))
    mt = tt._migrate(MigrationPlan(promote=torch.tensor(promote), demote=torch.tensor(demote)))
    assert mt == mj == 4
    assert np.array_equal(tt.slot_of, jt.slot_of)
    assert (tt.unpaired_promotes, tt.unpaired_demotes) == (jt.unpaired_promotes,
                                                           jt.unpaired_demotes) == (2, 0)
    for t, j in zip(tt.pools, jt.pools):
        assert np.array_equal(t.numpy(), np.asarray(j))
