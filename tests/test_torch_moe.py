"""The port's MoE serving path against the JAX package on the CPU: configs,
weights carried across, ``moe_mlp`` (routing, capacity ranks, drops), the
MoE prefill, the MoE branch of the Quest decode step, and a whole engine
run under the open-loop driver.

Both sides run qwen2-moe-a2.7b at ``.smoke()`` size (8 experts padded to
64, top 2, one shared expert) in float32 with the same weights (the
reference's random init, carried into the port by ``params_from_numpy``)
and the same numpy-made inputs. Gate ids, capacity ranks and drop masks
are bit-equal; ``moe_mlp``'s output within 1e-5 and its aux loss within
1e-6; logits within 1e-4 (float32 sums in another order, through a few
layers); access counts, ``slot_of`` and manager state bit-equal; pools
within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kvcache.paged import TieredPagedKV as JaxKV
from repro.models.model import get_model as jax_model
from repro.models.moe import moe_mlp as jax_moe_mlp
from repro.serving.baselines import make_serving_manager as jax_make_manager
from repro.serving.driver import OpenLoopDriver as JaxDriver
from repro.serving.driver import TenantSpec as JaxTenantSpec
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.paged_model import PagedPools as JaxPools
from repro.serving.paged_model import paged_decode_step as jax_decode_step
from repro_torch.configs import get_config
from repro_torch.core.types import state_to_numpy
from repro_torch.kvcache.paged import TieredPagedKV
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import get_model
from repro_torch.serving.baselines import make_serving_manager
from repro_torch.serving.driver import OpenLoopDriver, TenantSpec
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.paged_model import PagedPools, paged_decode_step

OUT_TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2-moe-a2.7b").smoke()
    tcfg = get_config("qwen2-moe-a2.7b").smoke()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.device_get(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=tol, rtol=tol)


def _pools_close(t_pools, j_pools):
    for t, j in zip(t_pools, j_pools):
        t, j = _np(t), np.asarray(j)
        fin = np.isfinite(j)
        assert np.array_equal(fin, np.isfinite(t))
        assert np.array_equal(t[~fin], j[~fin])  # the ±inf of reset summaries
        np.testing.assert_allclose(t[fin], j[fin], atol=POOL_TOL, rtol=POOL_TOL)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_moe_configs_match_reference(arch, smoke):
    jc, tc = jax_config(arch), get_config(arch)
    if smoke:
        jc, tc = jc.smoke(), tc.smoke()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.is_moe and tc.family == "moe"
    assert moe.padded_experts(tc) == max(jc.num_experts, jc.expert_pad_to)
    if arch == "qwen2-moe-a2.7b":  # expert_pad_to survives smoke(): 8 experts padded to 64
        assert moe.padded_experts(tc) == 64


# ------------------------------------------------------------ weights
def test_moe_params_carried_across_with_padded_experts(models):
    jcfg, tcfg, jparams, tparams = models
    jl = list(_leaves(jax.device_get(jparams)))
    assert any(p[:2] == ("layers", "moe") for p, _ in jl)
    for path, leaf in jl:
        assert np.array_equal(_at(tparams, path).numpy(), np.asarray(leaf)), path
    own = get_model(tcfg).init(seed=0, device="cpu")
    for path, leaf in jl:
        t = _at(own, path)
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32, path
    w = own["layers"]["moe"]
    L, d, E, ff = tcfg.num_layers, tcfg.d_model, tcfg.num_experts, tcfg.moe_d_ff
    assert w["router"].shape == (L, d, E) and w["w_gate"].shape == (L, 64, d, ff)
    assert abs(float(w["w_down"].std()) * ff ** 0.5 - 1.0) < 0.05

    # in bfloat16 the router stays float32 and the rest crosses bit for bit
    bcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    bparams = jax.device_get(jax_model(bcfg).init(jax.random.PRNGKey(1)))
    tb = params_from_numpy(dataclasses.replace(tcfg, param_dtype="bfloat16"), bparams, "cpu")
    assert tb["layers"]["moe"]["router"].dtype == torch.float32
    assert tb["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    for path, leaf in _leaves(bparams):
        assert np.array_equal(_at(tb, path).float().numpy(), np.asarray(leaf, np.float32)), path

    # a tree without the pad experts is refused
    cut = jax.device_get(jparams)
    cut = {**cut, "layers": {**cut["layers"], "moe": {
        **cut["layers"]["moe"], "w_up": np.asarray(cut["layers"]["moe"]["w_up"])[:, :E]}}}
    with pytest.raises(ValueError, match="w_up"):
        params_from_numpy(tcfg, cut, "cpu")


# ------------------------------------------------------------ moe_mlp
def _jax_routing(params, x, cfg):
    """The reference's routing as ``moe_mlp`` computes it (models/moe.py:80-95)."""
    T = x.shape[0] * x.shape[1]
    E, k = cfg.num_experts, cfg.moe_top_k
    xf = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ params["router"], axis=-1)
    _, gate_ids = jax.lax.top_k(probs, k)
    flat = gate_ids.reshape(T * k)
    rank = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(flat, E, dtype=jnp.int32), axis=0) - 1,
                               flat[:, None], axis=1)[:, 0]
    cap = max(8, ((int(np.ceil(T * k / E * cfg.capacity_factor)) + 7) // 8) * 8)
    return np.asarray(gate_ids), np.asarray(rank), np.asarray(rank < cap), cap


def _moe_input(cfg, case, rng):
    """``spread``: random tokens; ``skewed``: every token near one vector,
    so most route to the same experts and overflow the capacity."""
    if case == "spread":
        return rng.normal(size=(3, 5, cfg.d_model)).astype(np.float32)
    base = rng.normal(size=(1, 1, cfg.d_model))
    return (base + 0.05 * rng.normal(size=(2, 20, cfg.d_model))).astype(np.float32)


@pytest.mark.parametrize("case", ["spread", "skewed"])
def test_moe_mlp_matches_reference(models, case):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(3 if case == "spread" else 4)
    x = _moe_input(tcfg, case, rng)
    for l in range(tcfg.num_layers):
        jp = jax.tree_util.tree_map(lambda a: a[l], jparams["layers"]["moe"])
        tp = {k: (v[l] if not isinstance(v, dict) else {kk: vv[l] for kk, vv in v.items()})
              for k, v in tparams["layers"]["moe"].items()}
        j_ids, j_rank, j_valid, cap = _jax_routing(jp, x, jcfg)
        T = x.shape[0] * x.shape[1]
        assert moe.capacity(T, tcfg) == cap
        r = moe.route(tp["router"], torch.as_tensor(x).reshape(T, -1), tcfg, cap)
        assert np.array_equal(r.gate_ids.numpy(), j_ids)
        assert np.array_equal(r.rank.numpy(), j_rank)
        assert np.array_equal(r.valid.numpy(), j_valid)
        if case == "skewed":
            assert (~j_valid).sum() > 0, "the skewed batch must drop assignments"
        else:
            assert j_valid.all()
        j_out, j_aux = jax_moe_mlp(jp, jnp.asarray(x), jcfg)
        t_out, t_aux = moe.moe_mlp(tp, torch.as_tensor(x), tcfg)
        assert t_out.shape == x.shape and t_aux.dtype == torch.float32
        _close(t_out, j_out, OUT_TOL)
        _close(t_aux, j_aux, AUX_TOL)


def test_moe_routing_breaks_ties_like_lax_top_k():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25], [0.4, 0.1, 0.4, 0.1]])
    _, ids = moe.top_k(probs, 3)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.array_equal(ids.numpy(), np.asarray(want))


# ------------------------------------------------------------ prefill
def test_moe_prefill_logits_and_kv(models):
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
@pytest.mark.parametrize("quest_pages", [2, 6])
def test_moe_paged_decode_step_matches_reference(models, quest_pages):
    """Two active lanes and one inactive lane, three steps; the MoE layers
    route all three lanes."""
    jcfg, tcfg, jparams, tparams = models
    page, n_fast, n_slow = 4, 8, 24
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, 13)).astype(np.int32)
    _, jc = jax_model(jcfg).prefill(jparams, jnp.asarray(toks), 13)
    _, tc = get_model(tcfg).prefill(tparams, torch.as_tensor(toks.astype(np.int64)), 13)
    pages = np.array([[3, 9, 12, 20, -1, -1], [1, 5, 30, 7, -1, -1], [-1] * 6], np.int32)
    jkv = JaxKV(jcfg, n_fast, n_slow, page_tokens=page)
    tkv = TieredPagedKV(tcfg, n_fast, n_slow, page_tokens=page, device="cpu")
    jkv.write_tokens((jc.k, jc.v), pages[:2], 0)
    tkv.write_tokens((tc.k, tc.v), pages[:2], 0)
    slots = np.where(pages >= 0, jkv.slot_of[np.maximum(pages, 0)], -1).astype(np.int32)
    tokens, pos = np.array([5, 9, 0], np.int32), np.array([13, 13, 0], np.int32)
    active = np.array([True, True, False])
    for _ in range(3):
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
        assert torch.equal(tl[2], torch.zeros_like(tl[2]))
        assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
        _pools_close(tp, (jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min))
        tokens = np.asarray(np.argmax(np.asarray(jl), axis=-1), np.int32) * active
        pos = pos + active


def test_moe_decode_routes_inactive_lanes(models, monkeypatch):
    """The decode step's MoE layers see every lane: capacity is per step,
    C = 8 at batch 32 as at full width."""
    jcfg, tcfg, jparams, tparams = models
    seen = []
    inner = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda r, xf, cfg, cap: seen.append((xf.shape[0], cap)) or inner(
                            r, xf, cfg, cap))
    B, n_p, page = 5, 2, 4
    kv = TieredPagedKV(tcfg, 4, 12, page_tokens=page, device="cpu")
    active = torch.tensor([True, False, True, False, False])
    tables = torch.full((B, n_p), -1, dtype=torch.int64)
    tables[0, 0], tables[2, 0] = 0, 1
    paged_decode_step(tparams, torch.ones(B, dtype=torch.int64), torch.zeros(B, dtype=torch.int64),
                      tables, tables, active,
                      PagedPools(kv.k_pool, kv.v_pool, kv.k_max, kv.k_min),
                      num_logical_pages=16, cfg=tcfg, quest_pages=2)
    assert seen == [(B, 8)] * tcfg.num_layers
    full = get_config("qwen2-moe-a2.7b")
    assert moe.capacity(32, full) == 8 and moe.capacity(1024, full) == 88


# ------------------------------------------------------------ engine
FAST, SLOW, PAGE, BATCH, PER_SEQ, EPOCH, QUEUE, BW, HEADROOM = 16, 80, 4, 4, 8, 2, 32, 8, 6
TENANTS = (("ls", 0.1, 0.10, 12, 16), ("be", 1.0, 0.15, 16, 24))


def _engine_pair(jcfg, tcfg, jparams, tparams):
    kw = dict(num_pages=FAST + SLOW, fast_capacity=FAST, migration_budget=BW, queue_size=QUEUE,
              migration_bandwidth=BW, alloc_headroom=HEADROOM, max_tenants=4)
    ekw = dict(max_batch=BATCH, pages_per_seq=PER_SEQ, quest_pages=2, epoch_steps=EPOCH)
    je = JaxEngine(jcfg, jparams, jax_make_manager("maxmem", **kw),
                   JaxKV(jcfg, FAST, SLOW, page_tokens=PAGE), **ekw)
    te = ServingEngine(tcfg, tparams, make_serving_manager("maxmem", device="cpu", **kw),
                       TieredPagedKV(tcfg, FAST, SLOW, page_tokens=PAGE, device="cpu"), **ekw)
    return (je, JaxDriver(je, [JaxTenantSpec(*t) for t in TENANTS], seed=7),
            te, OpenLoopDriver(te, [TenantSpec(*t) for t in TENANTS], seed=7))


def test_moe_engine_run_matches_reference(models):
    jcfg, tcfg, jparams, tparams = models
    je, jd, te, td = _engine_pair(jcfg, tcfg, jparams, tparams)
    steps = 48
    jrep, trep = jd.run(steps), td.run(steps)

    def reqs(eng):
        done = {r.rid: (r.tenant, r.generated, r.admit_step, r.finish_step) for r in eng.finished}
        live = {r.rid: (r.tenant, r.generated, r.admit_step, -1) for r in eng.lanes if r}
        return done, live

    assert reqs(te) == reqs(je)
    assert len(te.finished) > 3 and te._migrated_pages > 0
    assert te._epoch_log == je._epoch_log
    assert trep == jrep
    assert np.array_equal(te.kv.slot_of, je.kv.slot_of)
    ts = state_to_numpy(te.manager._state)
    js = je.manager._state
    for part in ("pages", "tenants", "queue"):
        for name, t_leaf in getattr(ts, part)._asdict().items():
            j_leaf = np.asarray(getattr(getattr(js, part), name))
            assert np.array_equal(t_leaf, j_leaf.astype(t_leaf.dtype)), (part, name)
    _close(te.last_logits, je.last_logits, LOGIT_TOL)
    _pools_close((te.kv.k_pool, te.kv.v_pool, te.kv.k_max, te.kv.k_min),
                 (je.kv.k_pool, je.kv.v_pool, je.kv.k_max, je.kv.k_min))


def test_serve_launcher_runs_qwen2_moe_on_request_of_the_cpu(capsys):
    from repro_torch.launch.serve import main

    eng = main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--steps", "6"])
    out = capsys.readouterr().out
    assert "completed requests: 2" in out and eng.cfg.is_moe
    assert eng.decode_steps == 5 and eng.prefills == 2
