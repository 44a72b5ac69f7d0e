"""The port's attention and layer functions against the JAX package on the
same numpy inputs, on the CPU.

The port's ``ops.paged_attention`` / ``ops.flash_attention`` take their plain
versions for CPU tensors; the JAX side runs the Pallas kernels in interpret
mode and their jnp oracles. Tolerances are those of the reference's kernel
tests (``tests/test_kernels.py:21``): 2e-5 in float32, 2e-2 in bfloat16, for
float32 sums taken in another order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import split_plan, team_fits
from repro_torch.models import layers as TL

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    j = jnp.asarray(a, jnp.float32).astype(JDT[dt])
    return j, torch.as_tensor(np.array(j.astype(jnp.float32))).to(TDT[dt])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------ paged attention
def _paged_case(B, nh, nkv, dh, P, page, n_p, dt, seed):
    rng = np.random.default_rng(seed)
    q = _both(rng.normal(size=(B, nh, dh)), dt)
    kp = _both(rng.normal(size=(P, page, nkv, dh)), dt)
    vp = _both(rng.normal(size=(P, page, nkv, dh)), dt)
    tables = np.full((B, n_p), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        used = rng.integers(1, n_p + 1)
        tables[b, :used] = rng.choice(P, used, replace=False)
        lens[b] = rng.integers(1, used * page + 1)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("B,nh,nkv,dh,P,page,n_p", [
    (2, 4, 2, 64, 16, 8, 4),
    (3, 8, 1, 128, 32, 16, 6),
    (1, 4, 4, 64, 8, 8, 2),
    (4, 16, 2, 128, 64, 32, 8),
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_attention_matches_reference(B, nh, nkv, dh, P, page, n_p, dt):
    q, kp, vp, tables, lens = _paged_case(B, nh, nkv, dh, P, page, n_p, dt, B * 131 + P)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    tt, tl = torch.as_tensor(tables), torch.as_tensor(lens)
    got = ops.paged_attention(q[1], kp[1], vp[1], tt, tl)
    assert got.dtype == TDT[dt] and got.shape == (B, nh, dh)
    _close(got, jax_paged(q[0], kp[0], vp[0], jt, jl, interpret=True), TOL[dt])
    _close(got, jref.paged_attention_ref(q[0], kp[0], vp[0], jt, jl), TOL[dt])


def test_paged_attention_single_token_and_masked_rows():
    """seq_len 1 reads one key (the output is that key's value); a row whose
    table is all -1, or whose length is 0, returns 0 as the reference's."""
    rng = np.random.default_rng(3)
    q = _both(rng.normal(size=(3, 2, 64)), "float32")
    kp = _both(rng.normal(size=(4, 8, 2, 64)), "float32")
    vp = _both(rng.normal(size=(4, 8, 2, 64)), "float32")
    tables = np.asarray([[2, -1], [-1, -1], [1, 3]], np.int32)
    lens = np.asarray([1, 9, 0], np.int32)
    got = ops.paged_attention(q[1], kp[1], vp[1], torch.as_tensor(tables), torch.as_tensor(lens))
    np.testing.assert_allclose(got[0, 0].numpy(), vp[1][2, 0, 0].numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(got[1:], torch.zeros_like(got[1:]))
    want = jref.paged_attention_ref(q[0], kp[0], vp[0], jnp.asarray(tables), jnp.asarray(lens))
    _close(got, want, TOL["float32"])


# ------------------------------------------ the split-K merge of the CUDA kernel
def _split_case(dt):
    """Five-entry tables of 8-token pages: lane 0 has length 0; lane 1's
    middle entries are -1 (a split of 2 entries holds only -1); lane 2's
    length ends in its second page (later splits lie wholly past it);
    lane 3 has a hole and a ragged last page."""
    rng = np.random.default_rng(13)
    B, nh, nkv, dh, P, page = 4, 8, 2, 64, 24, 8
    q = _both(rng.normal(size=(B, nh, dh)), dt)
    kp = _both(rng.normal(size=(P, page, nkv, dh)), dt)
    vp = _both(rng.normal(size=(P, page, nkv, dh)), dt)
    tables = rng.choice(P, (B, 5)).astype(np.int32)
    tables[1, 2:4] = -1
    tables[3, 1] = -1
    lens = np.asarray([0, 40, 10, 35], np.int32)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("n_split", [1, 2, 3, 5])  # 5 = n_p: one entry a split
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_split_ref_matches_reference(n_split, dt):
    q, kp, vp, tables, lens = _split_case(dt)
    jt, jl = jnp.asarray(tables), jnp.asarray(lens)
    tt, tl = torch.as_tensor(tables), torch.as_tensor(lens)
    got = ref.paged_attention_split_ref(q[1], kp[1], vp[1], tt, tl, n_split)
    assert got.dtype == TDT[dt] and got.shape == q[1].shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # length 0 returns exactly 0
    assert bool(torch.isfinite(got.float()).all())
    _close(got, ref.paged_attention_ref(q[1], kp[1], vp[1], tt, tl).float().numpy(), TOL[dt])
    _close(got, jax_paged(q[0], kp[0], vp[0], jt, jl, interpret=True), TOL[dt])
    _close(got, jref.paged_attention_ref(q[0], kp[0], vp[0], jt, jl), TOL[dt])


@pytest.mark.parametrize("n_split", [1, 2, 4])
def test_paged_split_ref_all_holes(n_split):
    """A table of all -1 and lanes of length 0 return 0 from every split."""
    q, kp, vp, tables, lens = _split_case("float32")
    tables[1:] = -1
    got = ref.paged_attention_split_ref(q[1], kp[1], vp[1], torch.as_tensor(tables),
                                        torch.as_tensor(lens), n_split)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("B,nkv,n_p,sms,want", [
    (32, 4, 32, 132, (4, 8)),  # the yi-6b serving shape: 512 CTAs, ~4 per SM
    (32, 4, 33, 132, (5, 8)),  # a table width the split does not divide
    (2, 2, 4, 132, (4, 1)),  # tiny: one entry a split
    (1, 1, 1, 132, (1, 1)),
    (64, 8, 5, 132, (2, 3)),  # a wide batch needs few splits
    (32, 4, 32, 1, (1, 32)),  # one SM: no split
])
def test_paged_split_plan(B, nkv, n_p, sms, want):
    n_split, per = split_plan(B, nkv, n_p, sms)
    assert (n_split, per) == want
    assert (n_split - 1) * per < n_p <= n_split * per  # no empty split, every entry covered
    if n_p >= 4 * sms / (B * nkv):
        assert B * nkv * n_split >= 3 * sms  # about 4 CTAs per SM where the table allows


@pytest.mark.parametrize("dh,itemsize,g,fits", [
    (128, 2, 8, True),  # yi-6b in bf16: 2 teams of 16 lanes, 4 heads each
    (128, 4, 8, True),  # in f32: 1 team of 32 lanes, 8 heads
    (128, 4, 9, False),  # 9 heads round up to 16 > 8 a team
    (16, 2, 32, True),  # 16 teams of 2 lanes, 2 heads each
    (16, 2, 33, False),  # 3 heads round up to 4 > 2 lanes
    (64, 2, 1, True),
])
def test_paged_team_fits(dh, itemsize, g, fits):
    assert team_fits(dh, itemsize, g) is fits


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("B,nh,nkv,Sq,Skv,dh,window,causal", [
    (2, 4, 2, 64, 64, 64, 0, True),  # GQA
    (1, 4, 1, 48, 112, 32, 0, True),  # MQA, Sq < Skv: suffix alignment
    (1, 4, 2, 160, 160, 16, 64, True),  # sliding window 64, ragged tiles
    (2, 4, 2, 40, 72, 16, 0, False),  # not causal
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_matches_reference(B, nh, nkv, Sq, Skv, dh, window, causal, dt):
    rng = np.random.default_rng(Sq * 7 + Skv + dh)
    q = _both(rng.normal(size=(B, nh, Sq, dh)), dt)
    k = _both(rng.normal(size=(B, nkv, Skv, dh)), dt)
    v = _both(rng.normal(size=(B, nkv, Skv, dh)), dt)
    got = ops.flash_attention(q[1], k[1], v[1], causal=causal, sliding_window=window)
    assert got.dtype == TDT[dt] and got.shape == (B, nh, Sq, dh)
    tol = TOL[dt]
    _close(got, jax_flash(q[0], k[0], v[0], causal=causal, sliding_window=window, q_blk=32,
                          kv_blk=32, interpret=True), tol)
    _close(got, jref.flash_attention_ref(q[0], k[0], v[0], causal=causal,
                                         sliding_window=window), tol)
    if causal and Sq == Skv:  # the models' prefill attention, in [B, S, heads, dh]
        jb = JL.blocked_attention(*(x.transpose(0, 2, 1, 3) for x in (q[0], k[0], v[0])),
                                  causal=True, q_block=32, kv_block=64,
                                  sliding_window=window)
        _close(TL.causal_attention(*(x.transpose(1, 2) for x in (q[1], k[1], v[1])),
                                   sliding_window=window), jb, tol)


# ------------------------------------------------------------ layers
@pytest.fixture(scope="module")
def cfgs():
    return jax_config("yi-6b").smoke(), get_config("yi-6b").smoke()


def test_smoke_config_matches_reference(cfgs):
    jc, tc = cfgs
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_head", "d_ff",
              "vocab_size", "activation", "norm_eps", "rope_theta", "sliding_window",
              "tie_embeddings", "qkv_bias", "use_qk_norm"):
        assert getattr(jc, f) == getattr(tc, f), f
    # the hybrid architecture, ported with the SSM and encoder-decoder
    # families: its config equals the reference's, field for field
    jz, tz = jax_config("zamba2-1.2b"), get_config("zamba2-1.2b")
    assert dataclasses.asdict(tz) == dataclasses.asdict(jz)


def test_rms_norm_and_rope(cfgs):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    _close(TL.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)
    _close(TL.rope_freqs(16, 5e6), JL.rope_freqs(16, 5e6), 1e-7)
    _close(TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 5e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6), 2e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_branches(cfgs, activation):
    import dataclasses

    jc, tc = (dataclasses.replace(c, activation=activation) for c in cfgs)
    rng = np.random.default_rng(5)
    names = ["w_up", "w_down"] + (["w_gate"] if activation in ("swiglu", "geglu") else [])
    shapes = {"w_gate": (64, 128), "w_up": (64, 128), "w_down": (128, 64)}
    p = {n: (rng.normal(size=shapes[n]) / 8).astype(np.float32) for n in names}
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    _close(TL.mlp({n: torch.as_tensor(a) for n, a in p.items()}, torch.as_tensor(x), tc),
           JL.mlp({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jc), 1e-5)


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False), (False, True)])
def test_qkv_project_branches(cfgs, bias, qk_norm):
    import dataclasses

    jc, tc = (dataclasses.replace(c, qkv_bias=bias, use_qk_norm=qk_norm) for c in cfgs)
    rng = np.random.default_rng(6)
    d, nh, nkv, dh = 64, jc.num_heads, jc.num_kv_heads, jc.d_head
    p = {"w_q": (d, nh * dh), "w_k": (d, nkv * dh), "w_v": (d, nkv * dh)}
    if bias:
        p.update(b_q=(nh * dh,), b_k=(nkv * dh,), b_v=(nkv * dh,))
    if qk_norm:
        p.update(q_norm=(dh,), k_norm=(dh,))
    p = {n: (rng.normal(size=s) / 8).astype(np.float32) for n, s in p.items()}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    got = TL.qkv_project({n: torch.as_tensor(a) for n, a in p.items()}, torch.as_tensor(x), tc)
    want = JL.qkv_project({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jc)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-5)
