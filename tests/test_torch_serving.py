"""The port's serving slice against the JAX package on the CPU: weights
carried across, prefill, the Quest decode step, the tiered paged KV cache,
and a whole engine run under the open-loop driver.

Both sides serve yi-6b at ``.smoke()`` size in float32 with the same
weights (the reference's random init, carried into the port by
``params_from_numpy``) and the same numpy-made inputs. Logits agree within
1e-4 (float32 sums in another order, through a few layers); access counts,
Quest selections, ``slot_of`` and manager state agree bit for bit; pools
within 1e-5 (keys and values come out of float32 products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.manager import CentralManager as JaxManager
from repro.core.types import MigrationPlan as JaxPlan
from repro.kvcache.paged import TieredPagedKV as JaxKV
from repro.models.model import get_model as jax_model
from repro.serving.baselines import make_serving_manager
from repro.serving.driver import OpenLoopDriver as JaxDriver
from repro.serving.driver import TenantSpec as JaxTenantSpec
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.paged_model import PagedPools as JaxPools
from repro.serving.paged_model import paged_decode_step as jax_decode_step
from repro_torch.configs import get_config
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import MigrationPlan, state_to_numpy
from repro_torch.kvcache.paged import TieredPagedKV
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.model import get_model
from repro_torch.serving.driver import OpenLoopDriver, TenantSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged_model import PagedPools, paged_decode_step, quest_select

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("yi-6b").smoke()
    tcfg = get_config("yi-6b").smoke()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.device_get(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=tol, rtol=tol)


def _pools_close(tkv_pools, jkv_pools):
    for t, j in zip(tkv_pools, jkv_pools):
        t, j = _np(t), np.asarray(j)
        fin = np.isfinite(j)
        assert np.array_equal(fin, np.isfinite(t))
        assert np.array_equal(t[~fin], j[~fin])  # the ±inf of reset summaries
        np.testing.assert_allclose(t[fin], j[fin], atol=POOL_TOL, rtol=POOL_TOL)


# ------------------------------------------------------------ weights
def test_params_carried_across_and_init_shapes(models):
    jcfg, tcfg, jparams, tparams = models
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams))
    for path, leaf in jl:
        t = tparams
        for key in path:
            t = t[key.key]
        assert np.array_equal(t.numpy(), np.asarray(leaf)), path
    # the port's own init: the same tree, shapes and scales
    own = get_model(tcfg).init(seed=0, device="cpu")
    for path, leaf in jl:
        t = own
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, path
    w_q = own["layers"]["attn"]["w_q"]
    assert abs(float(w_q.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(own["embed"].std()) - 0.02) < 0.002
    # bfloat16 leaves cross bit for bit
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 77), jnp.bfloat16))
    t = tensor_from_numpy(a, torch.bfloat16, "cpu")
    assert np.array_equal(t.float().numpy(), a.astype(np.float32))


def test_prefill_logits_and_kv(models):
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jax_model(jcfg).prefill(jparams, jnp.asarray(toks), 16)
    tl, tc = get_model(tcfg).prefill(tparams, torch.as_tensor(toks.astype(np.int64)), 16)
    assert tl.shape == (2, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, LOGIT_TOL)
    assert tc.k.shape == jc.k.shape and tc.pos == int(jc.pos) == 13
    _close(tc.k, jc.k, POOL_TOL)
    _close(tc.v, jc.v, POOL_TOL)


# ------------------------------------------------------------ decode step
def _decode_inputs(models, page=4, n_fast=8, n_slow=24):
    """Three lanes: two active with 13-token prompts (the current page is
    the 4th), one inactive; pools filled by prefill in both packages."""
    jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, 13)).astype(np.int32)
    _, jc = jax_model(jcfg).prefill(jparams, jnp.asarray(toks), 13)
    _, tc = get_model(tcfg).prefill(tparams, torch.as_tensor(toks.astype(np.int64)), 13)
    pages = np.array([[3, 9, 12, 20, -1, -1], [1, 5, 30, 7, -1, -1], [-1] * 6], np.int32)
    jkv = JaxKV(jcfg, n_fast, n_slow, page_tokens=page)
    tkv = TieredPagedKV(tcfg, n_fast, n_slow, page_tokens=page, device="cpu")
    jkv.write_tokens((jc.k, jc.v), pages[:2], 0)
    tkv.write_tokens((tc.k, tc.v), pages[:2], 0)
    return jkv, tkv, pages


@pytest.mark.parametrize("quest_pages", [2, 3, 6, 8])  # < n_p, and >= n_p = 6
def test_paged_decode_step_matches_reference(models, quest_pages):
    jcfg, tcfg, jparams, tparams = models
    jkv, tkv, pages = _decode_inputs(models)
    _pools_close((tkv.k_pool, tkv.v_pool, tkv.k_max, tkv.k_min),
                 (jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min))
    slots = np.where(pages >= 0, jkv.slot_of[np.maximum(pages, 0)], -1).astype(np.int32)
    tokens = np.array([5, 9, 0], np.int32)
    pos = np.array([13, 13, 0], np.int32)
    active = np.array([True, True, False])
    for _ in range(3):  # three steps: the current (4th) page fills up
        jl, jp, jcnt = jax_decode_step(
            jparams, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(slots),
            jnp.asarray(pages), jnp.asarray(active),
            JaxPools(jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min),
            num_logical_pages=32, cfg=jcfg, quest_pages=quest_pages,
        )
        jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min = jp
        tl, tp, tcnt = paged_decode_step(
            tparams, torch.as_tensor(tokens), torch.as_tensor(pos), torch.as_tensor(slots),
            torch.as_tensor(pages), torch.as_tensor(active),
            PagedPools(tkv.k_pool, tkv.v_pool, tkv.k_max, tkv.k_min),
            num_logical_pages=32, cfg=tcfg, quest_pages=quest_pages,
        )
        _close(tl, jl, LOGIT_TOL)
        assert torch.equal(tl[2], torch.zeros_like(tl[2]))  # the inactive lane
        assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))  # Quest selections
        # each active lane counts its selected allocated pages (4 of them)
        assert int(tcnt.sum()) == 2 * tcfg.num_layers * min(quest_pages, 4)
        _pools_close(tp, (jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min))
        tokens = np.asarray(np.argmax(np.asarray(jl), axis=-1), np.int32) * active
        pos = pos + active


def test_quest_selection_breaks_ties_like_lax_top_k():
    """Equal scores select the lower table position first, as lax.top_k
    does; the current page always comes first."""
    B, n_p, nkv, g, dh = 3, 8, 1, 2, 4
    q = torch.ones(B, nkv * g, dh)
    kmx = torch.zeros(10, nkv, dh)
    kmx[5] = 1.0  # one hot slot, all others tie at 0
    kmn = kmx.clone()
    st = torch.tensor([[0, 1, 2, 3, 4, 5, 6, 7], [7, 6, 5, 4, 3, 2, 1, 0],
                       [0, 1, 2, -1, 4, 5, -1, 7]])
    valid = (st >= 0) & (torch.arange(n_p) < 7)
    cur = torch.tensor([6, 0, 4])
    sel = quest_select(q, kmx, kmn, st, valid, cur, 5)
    score = torch.where(valid, (kmx[st.clamp(min=0)].sum((2, 3)) * g), -1e30)
    score = torch.where(torch.arange(n_p) == cur[:, None], torch.inf, score)
    _, want = jax.lax.top_k(jnp.asarray(score.numpy()), 5)
    assert np.array_equal(sel.numpy(), np.asarray(want))
    assert sel[:, 0].tolist() == cur.tolist()


# ------------------------------------------------------------ KV cache
def _kv_pair(models, n_fast=8, n_slow=24, page=4):
    jcfg, tcfg, _, _ = models
    kw = dict(num_pages=n_fast + n_slow, fast_capacity=n_fast, migration_budget=8,
              max_tenants=4, sample_period=1, exact_sampling=True)
    jm, tm = JaxManager(**kw), CentralManager(device="cpu", **kw)
    return (jm, JaxKV(jcfg, n_fast, n_slow, page_tokens=page),
            tm, TieredPagedKV(tcfg, n_fast, n_slow, page_tokens=page, device="cpu"))


def _kv_equal(tkv, jkv):
    assert np.array_equal(tkv.slot_of, jkv.slot_of)
    for t, j in ((tkv.k_pool, jkv.k_pool), (tkv.v_pool, jkv.v_pool),
                 (tkv.k_max, jkv.k_max), (tkv.k_min, jkv.k_min)):
        assert np.array_equal(t.numpy(), np.asarray(j))


def test_kv_cache_writes_migrations_and_frees(models):
    jcfg, tcfg, _, _ = models
    jm, jkv, tm, tkv = _kv_pair(models)
    rng = np.random.default_rng(2)
    L, nkv, dh = jcfg.num_layers, jcfg.num_kv_heads, jcfg.d_head
    hj, ht = jm.register(0.1), tm.register(0.1)
    pj, pt = jm.allocate(hj, 12), tm.allocate(ht, 12)  # 8 fast, 4 slow
    assert np.array_equal(np.asarray(pj), pt)
    k = rng.normal(size=(L, 3, 16, nkv, dh)).astype(np.float32)
    v = rng.normal(size=(L, 3, 16, nkv, dh)).astype(np.float32)
    table = np.asarray(pt, np.int32).reshape(3, 4)
    jkv.write_tokens((jnp.asarray(k), jnp.asarray(v)), table, start_pos=0)
    tkv.write_tokens((torch.as_tensor(k), torch.as_tensor(v)), table, start_pos=0)
    _kv_equal(tkv, jkv)
    before = {int(p): tkv.read_page(int(p)) for p in pt}

    # an instant plan: demote two fast pages, promote two slow ones
    plan = ([8, 9, -1], [0, 1, -1])
    moved_j = jkv.migrate(JaxPlan(promote=jnp.asarray(plan[0]), demote=jnp.asarray(plan[1])), jm)
    moved_t = tkv.migrate(MigrationPlan(promote=torch.tensor(plan[0]),
                                        demote=torch.tensor(plan[1])), tm)
    assert moved_t == moved_j == 4
    _kv_equal(tkv, jkv)
    for p, (kb, vb) in before.items():  # every page keeps its bytes
        kn, vn = tkv.read_page(p)
        assert torch.equal(kn, kb) and torch.equal(vn, vb)

    # free pages: scrubbed slots; then a drained batch swaps with free holders
    for m, kv, h, pages in ((jm, jkv, hj, pj), (tm, tkv, ht, pt)):
        kv.free_pages(pages[4:8])
        m.free(h, np.asarray(pages[4:8]))
    _kv_equal(tkv, jkv)
    freed = tkv.slot_of[np.asarray(pt[4:8])]
    assert not tkv.k_pool[:, freed].any() and torch.isinf(tkv.k_max[:, freed]).all()
    drained = (np.array([10, 11, -1, -1]), np.array([2, 3, 0, -1]))
    moved_j = jkv.apply_drained(*drained, jm)
    moved_t = tkv.apply_drained(torch.as_tensor(drained[0]), torch.as_tensor(drained[1]), tm)
    assert moved_t == moved_j > 0
    _kv_equal(tkv, jkv)
    assert sorted(tkv.slot_of.tolist()) == list(range(tkv.n_slots))


# ------------------------------------------------------------ engine
# benchmarks/serving_colocation.py's machine and tenants, maxmem leg
FAST, SLOW, PAGE, BATCH, PER_SEQ, EPOCH, QUEUE, BW, HEADROOM = 16, 80, 4, 4, 8, 2, 32, 8, 6
TENANTS = (("ls", 0.1, 0.10, 12, 16), ("be", 1.0, 0.15, 16, 24))


def _run_jax_engine(jcfg, jparams, steps):
    m = make_serving_manager("maxmem", num_pages=FAST + SLOW, fast_capacity=FAST,
                             migration_budget=BW, queue_size=QUEUE, migration_bandwidth=BW,
                             alloc_headroom=HEADROOM, max_tenants=4)
    eng = JaxEngine(jcfg, jparams, m, JaxKV(jcfg, FAST, SLOW, page_tokens=PAGE),
                    max_batch=BATCH, pages_per_seq=PER_SEQ, quest_pages=2, epoch_steps=EPOCH)
    drv = JaxDriver(eng, [JaxTenantSpec(*t) for t in TENANTS], seed=7)
    return eng, drv, drv.run(steps)


def _run_port_engine(tcfg, tparams, steps):
    m = CentralManager(num_pages=FAST + SLOW, fast_capacity=FAST, migration_budget=BW,
                       max_tenants=4, sample_period=1, exact_sampling=True, queue_size=QUEUE,
                       migration_bandwidth=BW, alloc_headroom=HEADROOM, device="cpu")
    eng = ServingEngine(tcfg, tparams, m,
                        TieredPagedKV(tcfg, FAST, SLOW, page_tokens=PAGE, device="cpu"),
                        max_batch=BATCH, pages_per_seq=PER_SEQ, quest_pages=2,
                        epoch_steps=EPOCH)
    drv = OpenLoopDriver(eng, [TenantSpec(*t) for t in TENANTS], seed=7)
    return eng, drv, drv.run(steps)


def test_engine_run_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models
    steps = 64
    je, _, jrep = _run_jax_engine(jcfg, jparams, steps)
    te, _, trep = _run_port_engine(tcfg, tparams, steps)

    def reqs(eng):
        done = {r.rid: (r.tenant, r.generated, r.admit_step, r.finish_step) for r in eng.finished}
        live = {r.rid: (r.tenant, r.generated, r.admit_step, -1) for r in eng.lanes if r}
        return done, live

    assert reqs(te) == reqs(je)  # generated tokens, admissions, finishes
    assert len(te.finished) > 3 and te._migrated_pages > 0
    assert te._epoch_log == je._epoch_log  # moved pages, queue depth, FMMR
    assert trep == jrep
    assert np.array_equal(te.kv.slot_of, je.kv.slot_of)
    assert np.array_equal(te.tables, je.tables)
    ts = state_to_numpy(te.manager._state)
    js = je.manager._state
    for part in ("pages", "tenants", "queue"):
        for name, t_leaf in getattr(ts, part)._asdict().items():
            j_leaf = np.asarray(getattr(getattr(js, part), name))
            assert np.array_equal(t_leaf, j_leaf.astype(t_leaf.dtype)), (part, name)
    assert te.manager.queue_counters() == je.manager.queue_counters()
    _close(te.last_logits, je.last_logits, LOGIT_TOL)
    _pools_close((te.kv.k_pool, te.kv.v_pool, te.kv.k_max, te.kv.k_min),
                 (je.kv.k_pool, je.kv.v_pool, je.kv.k_max, je.kv.k_min))


def test_serve_launcher_runs_on_request_of_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` drives the engine end to end;
    on the CPU only when asked."""
    from repro_torch.launch.serve import main

    eng = main(["--device", "cpu", "--steps", "8"])
    out = capsys.readouterr().out
    assert "completed requests: 2" in out and eng.device.type == "cpu"
    # 8 tokens each: the first from prefill, 7 from decode steps
    assert eng.decode_steps == 7 and eng.prefills == 2
    assert sorted(eng.kv.slot_of.tolist()) == list(range(eng.kv.n_slots))
