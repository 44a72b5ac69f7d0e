"""The port's dense LM stack against the JAX package on the CPU, its layers:
the blocked (training) attention and its gradients, the contiguous-cache
decode attention, the norms, the tuning flags, the CE chunk rule and the
config registry (the models are in ``test_torch_lm_models.py``).

Both sides get the same numpy-made inputs. Tolerances: attention 2e-6 in
float32 and 2e-2 with bf16 inputs or scores (one bf16 rounding of O(1)
values), its gradients 1e-5; the CE sum 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import tuning as jtuning
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import layers as TL
from repro_torch.models import moe, tuning
from repro_torch.models.transformer import ce_chunk_size

LOSS_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol)


def _both(a, dt="float32"):
    a = np.asarray(a, np.float32)
    if dt == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.tensor(a)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("B,Sq,Skv,nh,nkv,causal,window,q_offset,qb,kb", [
    (2, 40, 40, 4, 2, True, 0, 0, 16, 16),  # GQA, S a multiple of the blocks
    (2, 37, 37, 4, 1, True, 0, 0, 16, 16),  # MQA, keys padded (37 -> 48)
    (1, 24, 56, 4, 4, False, 0, 0, 8, 24),  # not causal, keys padded (56 -> 72)
    (2, 70, 70, 4, 2, True, 20, 0, 32, 32),  # sliding window 20, padded
    (1, 16, 48, 4, 2, True, 0, 32, 8, 16),  # q_offset: the last 16 of 48 positions
    (1, 16, 48, 4, 2, True, 12, 32, 64, 64),  # q_offset and a window, blocks > S
])
@pytest.mark.parametrize("score_f32", [True, False], ids=["scores_f32", "scores_bf16"])
def test_blocked_attention_matches_reference(B, Sq, Skv, nh, nkv, causal, window, q_offset,
                                             qb, kb, score_f32):
    rng = np.random.default_rng(Sq * 31 + Skv + window)
    dt = "float32" if score_f32 else "bfloat16"  # bf16 scores come with bf16 activations
    q, k, v = (_both(rng.normal(size=(B, S, h, 16)), dt)
               for S, h in ((Sq, nh), (Skv, nkv), (Skv, nkv)))
    kw = dict(causal=causal, q_block=qb, kv_block=kb, sliding_window=window, q_offset=q_offset)
    with jtuning.tuned(attn_score_f32=score_f32), tuning.tuned(attn_score_f32=score_f32):
        want = JL.blocked_attention(q[0], k[0], v[0], **kw)
        got = TL.blocked_attention(q[1], k[1], v[1], **kw)
    assert got.shape == (B, Sq, nh, 16) and got.dtype == q[1].dtype
    _close(got, want, 2e-6 if score_f32 else 2e-2)


def test_blocked_attention_fully_masked_rows_are_zero():
    """A window that ends before every key of a query (q_offset past the
    keys by more than the window) masks the whole row: zero, not NaN, in
    both packages."""
    rng = np.random.default_rng(3)
    q, k, v = (_both(rng.normal(size=(1, 8, 2, 16))) for _ in range(3))
    kw = dict(causal=True, q_block=4, kv_block=4, sliding_window=4, q_offset=20)
    want = JL.blocked_attention(q[0], k[0], v[0], **kw)
    got = TL.blocked_attention(q[1], k[1], v[1], **kw)
    assert np.all(np.asarray(want)[:, :4] == 0) and torch.all(got[:, :4] == 0)
    _close(got, want, 2e-6)


def test_blocked_attention_gradients_match_reference():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 37, h, 16)).astype(np.float32) for h in (4, 2, 2))
    kw = dict(causal=True, q_block=16, kv_block=16, sliding_window=24)
    w = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    gj = jax.grad(lambda a, b, c: jnp.sum(JL.blocked_attention(a, b, c, **kw) * w),
                  argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (TL.blocked_attention(tq, tk, tv, **kw) * torch.tensor(w)).sum().backward()
    for t, j in zip((tq, tk, tv), gj):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, j, 1e-5)


@pytest.mark.parametrize("length,window", [(11, 0), (1, 0), ([3, 11, 7], 0), (11, 4),
                                           ([0, 5, 9], 3)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_attention_and_stats_match_reference(length, window, dt):
    rng = np.random.default_rng(len(str(length)) + window)
    B, S, nh, nkv, dh = 3, 12, 4, 2, 16
    q = _both(rng.normal(size=(B, 1, nh, dh)), dt)
    kc, vc = (_both(rng.normal(size=(B, S, nkv, dh)), dt) for _ in range(2))
    jlen = jnp.asarray(length, jnp.int32)
    tlen = torch.tensor(length) if isinstance(length, list) else length
    tol = 2e-6 if dt == "float32" else 2e-2
    jacc, jm, jl = JL.decode_attention_stats(q[0], kc[0], vc[0], jlen, sliding_window=window)
    tacc, tm, tl = TL.decode_attention_stats(q[1], kc[1], vc[1], tlen, sliding_window=window)
    assert tacc.shape == (B, nkv, nh // nkv, 1, dh) and tacc.dtype == torch.float32
    assert np.array_equal(np.isneginf(np.asarray(jm)), torch.isneginf(tm).numpy())
    fin = np.isfinite(np.asarray(jm))
    _close(tm.numpy()[fin], np.asarray(jm)[fin], tol)
    _close(tl, jl, tol)
    _close(tacc, jacc, tol)
    if 0 in np.atleast_1d(length):  # decode_attention of an empty context is NaN in both
        return
    want = JL.decode_attention(q[0], kc[0], vc[0], jlen, sliding_window=window)
    got = TL.decode_attention(q[1], kc[1], vc[1], tlen, sliding_window=window)
    assert got.shape == (B, 1, nh, dh) and got.dtype == q[1].dtype
    _close(got, want, tol)


# ------------------------------------------------------------ norms
def test_layer_norm_matches_reference():
    rng = np.random.default_rng(7)
    x, w, b = (rng.normal(size=s).astype(np.float32) * 3 + 1 for s in ((2, 5, 48), (48,), (48,)))
    for dt, tol in (("float32", 2e-6), ("bfloat16", 1e-2)):
        (jx, tx), (jw, tw), (jb, tb) = (_both(a, dt) for a in (x, w, b))
        got = TL.layer_norm(tx, tw, tb, 1e-5)
        assert got.dtype == tx.dtype
        _close(got, JL.layer_norm(jx, jw, jb, 1e-5), tol)


@pytest.mark.parametrize("bf16_apply", [False, True])
def test_rms_norm_bf16_branch_matches_reference(bf16_apply):
    rng = np.random.default_rng(8)
    (jx, tx), (jw, tw) = (_both(rng.normal(size=s) * 2, "bfloat16") for s in ((3, 7, 64), (64,)))
    with jtuning.tuned(norm_bf16_apply=bf16_apply), tuning.tuned(norm_bf16_apply=bf16_apply):
        want = JL.rms_norm(jx, jw, 1e-5)
        got = TL.rms_norm(tx, tw, 1e-5)
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


# ------------------------------------------------------------ configs
def test_config_registry_matches_reference():
    """The port has every architecture of the reference, each equal to the
    reference's field for field (dtypes by name), at full size and at smoke
    size; the two records have the same fields."""
    assert set(ARCH_NAMES) == set(JAX_ARCHS)
    for name in ARCH_NAMES:
        for jc, tc in ((jax_config(name), get_config(name)),
                       (jax_config(name).smoke(), get_config(name).smoke())):
            assert ({f.name for f in dataclasses.fields(tc)}
                    == {f.name for f in dataclasses.fields(jc)})
            for f in dataclasses.fields(tc):
                assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)
            assert str(tc.pdtype).endswith(tc.param_dtype)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("not-an-arch")


def test_tuning_flags_match_reference():
    assert dataclasses.asdict(tuning.TuningFlags()) == dataclasses.asdict(jtuning.TuningFlags())
    with tuning.tuned(q_block=64, kv_block=32) as f:
        assert (f.q_block, f.kv_block) == (64, 32)
    assert (tuning.FLAGS.q_block, tuning.FLAGS.kv_block) == (512, 1024)


def test_capacity_factor_override():
    cfg = get_config("qwen2-moe-a2.7b").smoke()
    jcfg = jax_config("qwen2-moe-a2.7b").smoke()
    from repro.models.moe import _capacity as jax_capacity
    for cf in (None, 0.5, 2.0, 4.0):
        with tuning.tuned(capacity_factor=cf), jtuning.tuned(capacity_factor=cf):
            assert moe.capacity(96, cfg) == jax_capacity(96, jcfg)
    base = moe.capacity(96, cfg)
    with tuning.tuned(capacity_factor=4.0):
        assert moe.capacity(96, cfg) > base


def test_ce_chunk_rule_matches_reference():
    from repro.models.transformer import chunked_ce_loss as jax_ce
    rng = np.random.default_rng(9)
    # 64e6 / (B V 4) floored to a power of two, within [16, S]
    assert [ce_chunk_size(*a) for a in ((2, 24, 256), (1, 100, 32), (2, 4096, 151936),
                                        (8, 4096, 151936))] == [16, 64, 32, 16]
    # a ragged S with ignored labels, chunk forced small: sums and counts
    h = rng.normal(size=(2, 37, 16)).astype(np.float32)
    head = rng.normal(size=(16, 50)).astype(np.float32)
    lab = rng.integers(-1, 50, (2, 37)).astype(np.int32)
    cfg = get_config("yi-6b").smoke()
    from repro_torch.models.transformer import chunked_ce_loss
    jt, jn = jax_ce(jnp.asarray(h), jnp.asarray(head), jnp.asarray(lab), None, chunk=16)
    tt, tn = chunked_ce_loss(torch.tensor(h), torch.tensor(head), torch.tensor(lab), cfg,
                             chunk=16)
    assert float(tn) == float(jn) == float((lab >= 0).sum())
    _close(tt, jt, LOSS_TOL)


