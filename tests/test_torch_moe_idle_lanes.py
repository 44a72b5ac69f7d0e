"""Idle decode lanes under MoE capacity: the port against the JAX package.

An inactive lane's attention is masked everywhere. The reference clamps its
table to slot 0 where it is -1 and softmaxes a row of finite ``NEG_INF``
scores, so the lane's attention output is the uniform mean of the V rows it
gathers. Capacity couples the lanes of an MoE step (ranks run in lane
order), so an idle lane's hidden state decides which assignments are
dropped. This test holds a step that overflows: qwen2-moe-a2.7b smoke
(8 experts, top 2), batch 16 and so capacity 8, four active lanes and twelve
idle ones. Ten idle lanes have empty tables and share one hidden state, so
they pick the same two experts and overflow them; two have tables of real
pages and a nonzero position, so the clamp-and-gather rule is held on real
rows, not on slot 0 alone.

Gate ids, capacity ranks and drop masks must be bit-equal with the
reference at every MoE layer of three steps; the active lanes' logits agree
within 1e-4 (``test_torch_moe.py``'s decode tolerance), access counts are
bit-equal and the pools agree within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.paged_model as jax_paged_model
from repro.configs import get_config as jax_config
from repro.kvcache.paged import TieredPagedKV as JaxKV
from repro.models.model import get_model as jax_model
from repro.serving.paged_model import PagedPools as JaxPools
from repro.serving.paged_model import paged_decode_step as jax_decode_step
from repro_torch.configs import get_config
from repro_torch.kvcache.paged import TieredPagedKV
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import get_model
from repro_torch.serving.paged_model import PagedPools, paged_decode_step

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
B, PAGE, N_P, N_FAST, N_SLOW, STEPS, QUEST = 16, 4, 6, 8, 24, 3, 4


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("qwen2-moe-a2.7b").smoke()
    tcfg = get_config("qwen2-moe-a2.7b").smoke()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.device_get(jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _jax_routing(p, x, cfg):
    """The reference's routing of ``moe_mlp`` (models/moe.py:80-95) on the
    input the decode step hands it."""
    T = x.shape[0] * x.shape[1]
    E, k = cfg.num_experts, cfg.moe_top_k
    xf = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
    _, gate_ids = jax.lax.top_k(probs, k)
    flat = gate_ids.reshape(T * k)
    rank = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(flat, E, dtype=jnp.int32), axis=0) - 1,
                               flat[:, None], axis=1)[:, 0]
    cap = moe.capacity(T, cfg)
    return np.asarray(gate_ids), np.asarray(rank), np.asarray(rank < cap)


def _pools_close(t_pools, j_pools):
    for t, j in zip(t_pools, j_pools):
        t, j = t.numpy(), np.asarray(j)
        fin = np.isfinite(j)
        assert np.array_equal(fin, np.isfinite(t))
        assert np.array_equal(t[~fin], j[~fin])
        np.testing.assert_allclose(t[fin], j[fin], atol=POOL_TOL, rtol=POOL_TOL)


def test_idle_lanes_route_like_the_reference_when_capacity_overflows(models, monkeypatch):
    jcfg, tcfg, jparams, tparams = models
    assert moe.capacity(B, tcfg) == 8
    toks = np.random.default_rng(5).integers(1, jcfg.vocab_size, (4, 13)).astype(np.int32)
    _, jc = jax_model(jcfg).prefill(jparams, jnp.asarray(toks), 13)
    _, tc = get_model(tcfg).prefill(tparams, torch.as_tensor(toks.astype(np.int64)), 13)
    pages = np.full((B, N_P), -1, np.int32)
    pages[:4, :4] = [[3, 9, 12, 20], [1, 5, 30, 7], [2, 14, 26, 11], [6, 17, 23, 29]]
    jkv = JaxKV(jcfg, N_FAST, N_SLOW, page_tokens=PAGE)
    tkv = TieredPagedKV(tcfg, N_FAST, N_SLOW, page_tokens=PAGE, device="cpu")
    jkv.write_tokens((jc.k, jc.v), pages[:4, :4], 0)
    tkv.write_tokens((tc.k, tc.v), pages[:4, :4], 0)
    # two idle lanes keep tables of written pages (a -1 entry among them)
    # and a position past their first page
    pages[4, :3] = [9, -1, 30]
    pages[5, :4] = [17, 2, 5, 12]
    slots = np.where(pages >= 0, jkv.slot_of[np.maximum(pages, 0)], -1).astype(np.int32)
    active = np.zeros(B, bool)
    active[:4] = True
    tokens = np.zeros(B, np.int32)
    tokens[:4] = [5, 9, 40, 77]
    tokens[4:6] = [3, 8]
    pos = np.zeros(B, np.int32)
    pos[:4] = 13
    pos[4:6] = [9, 6]

    j_seen, t_seen = [], []
    inner_jax = jax_paged_model.moe_mlp
    monkeypatch.setattr(jax_paged_model, "moe_mlp",
                        lambda p, x, cfg: j_seen.append(_jax_routing(p, x, cfg))
                        or inner_jax(p, x, cfg))
    inner_route = moe.route

    def spy_route(router, xf, cfg, cap):
        r = inner_route(router, xf, cfg, cap)
        t_seen.append((r.gate_ids.numpy(), r.rank.numpy(), r.valid.numpy()))
        return r

    monkeypatch.setattr(moe, "route", spy_route)

    dropped = 0
    for _ in range(STEPS):
        j_seen.clear()
        t_seen.clear()
        with jax.disable_jit():  # the layer scan runs in Python, so the spy sees each layer
            jl, jp, jcnt = jax_decode_step(
                jparams, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(slots),
                jnp.asarray(pages), jnp.asarray(active),
                JaxPools(jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min),
                num_logical_pages=32, cfg=jcfg, quest_pages=QUEST,
            )
        jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min = jp
        tl, tp, tcnt = paged_decode_step(
            tparams, torch.as_tensor(tokens), torch.as_tensor(pos), torch.as_tensor(slots),
            torch.as_tensor(pages), torch.as_tensor(active),
            PagedPools(tkv.k_pool, tkv.v_pool, tkv.k_max, tkv.k_min),
            num_logical_pages=32, cfg=tcfg, quest_pages=QUEST,
        )
        assert len(j_seen) == len(t_seen) == tcfg.num_layers
        for l, ((jid, jrank, jvalid), (tid, trank, tvalid)) in enumerate(zip(j_seen, t_seen)):
            assert np.array_equal(tid, jid), f"layer {l}: gate ids differ"
            assert np.array_equal(trank, jrank), f"layer {l}: ranks differ"
            assert np.array_equal(tvalid, jvalid), f"layer {l}: drops differ"
            dropped += int((~jvalid).sum())
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
        _pools_close(tp, (jkv.k_pool, jkv.v_pool, jkv.k_max, jkv.k_min))
        nxt = np.asarray(np.argmax(np.asarray(jl), axis=-1), np.int32)
        tokens = np.where(active, nxt, tokens).astype(np.int32)
        pos = pos + active
    assert dropped > 0, "the step must overflow an expert's capacity"
