"""The port's Mamba2 / SSD layer (``repro_torch.models.ssm``) against the JAX
package's on the CPU: the causal conv, the chunked SSD scan (ragged length,
an initial state), the full-sequence layer with its cache tail, the
recurrent decode step, and the scan's gradient at the published chunk
lengths.

Both sides get the same numpy-made inputs. Tolerances: float32 results
within 1e-5 of the largest entry (float32 sums in another order); the
gradients within 1e-4 of the largest entry; bf16 results within 2e-2 in
relative L2 (one bf16 rounding of O(1) values, and XLA:CPU keeps excess
precision through fused bf16 chains that torch rounds op by op).

The SSD gradient: the reference computes exp(ac_i - ac_j) over every pair
of a chunk and discards the pairs above the diagonal after ``exp``; at a
chunk of 128 those exponents overflow, and the backward turns the discarded
infinities into NaN. The port masks the exponent before ``exp``. The tests
show the reference's gradients are not finite on these inputs at chunk 128
(and are at chunk 16), that the port's are finite and equal the reference's
at chunk 16 (SSD computes the same function at every chunk length), and that
masking the exponent changes no bit of the forward pass.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as JS
from repro.models import tuning as jtuning
from repro_torch.configs import get_config
from repro_torch.models import ssm as TS
from repro_torch.models import tuning
from repro_torch.models.convert import params_from_numpy

TOL = 1e-5
GRAD_TOL = 1e-4
BF16_L2 = 2e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(t, j, tol=TOL):
    """Within ``tol`` of the reference's largest entry."""
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=tol * max(np.abs(j).max(), 1.0), rtol=0)


def _rel_l2(t, j) -> float:
    t, j = _np(t), _np(j)
    return float(np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30))


def _scan_inputs(seed, B, L, H, P, N, dt_range=(0.05, 0.3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L, H, P)).astype(np.float32),
            rng.uniform(*dt_range, size=(B, L, H)).astype(np.float32),
            np.log(rng.uniform(1, 16, size=(H,))).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32),
            rng.normal(size=(B, L, N)).astype(np.float32))


# ------------------------------------------------------------ conv, scan
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = JS._causal_conv(*(jnp.asarray(a, jd) for a in (x, w, b)))
    got = TS._causal_conv(*(torch.tensor(a).to(td) for a in (x, w, b)))
    assert got.dtype == td
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel_l2(got, want) <= BF16_L2


@pytest.mark.parametrize("L,chunk,init", [
    (48, 16, False),  # a multiple of the chunk
    (37, 16, False),  # ragged: padded to 48
    (37, 16, True),  # ragged, from an initial state
    (9, 16, True),  # shorter than one chunk
])
def test_ssd_scan_matches_reference(L, chunk, init):
    args = _scan_inputs(L + chunk, 2, L, 3, 8, 16)
    h0 = np.random.default_rng(5).normal(size=(2, 3, 8, 16)).astype(np.float32) if init else None
    jy, js = JS.ssd_scan(*(jnp.asarray(a) for a in args), chunk,
                         initial_state=None if h0 is None else jnp.asarray(h0))
    ty, ts = TS.ssd_scan(*(torch.tensor(a) for a in args), chunk,
                         initial_state=None if h0 is None else torch.tensor(h0))
    _close(ty, jy)
    _close(ts, js)
    assert ts.dtype == torch.float32


def test_ssd_scan_bf16_matches_reference():
    """bf16 activations (float32 dt and state), the model's dtypes."""
    xh, dt, A_log, Bm, Cm = _scan_inputs(21, 2, 40, 3, 8, 16)
    jy, js = JS.ssd_scan(jnp.asarray(xh, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A_log),
                         jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16), 16)
    bf = torch.bfloat16
    ty, ts = TS.ssd_scan(torch.tensor(xh).to(bf), torch.tensor(dt), torch.tensor(A_log),
                         torch.tensor(Bm).to(bf), torch.tensor(Cm).to(bf), 16)
    assert ty.dtype == bf and ts.dtype == torch.float32
    assert _rel_l2(ty, jy) <= BF16_L2
    assert _rel_l2(ts, js) <= BF16_L2


@pytest.mark.parametrize("per_group", [1, 2, 4])
def test_chunk_groups_change_no_bit(monkeypatch, per_group):
    """The scan's chunk groups (bounded memory, the state carried from group
    to group) change no bit on the CPU, with an initial state too."""
    args = [torch.tensor(a) for a in _scan_inputs(8, 2, 90, 3, 8, 16)]  # 6 chunks, ragged
    h0 = torch.tensor(np.random.default_rng(1).normal(size=(2, 3, 8, 16)).astype(np.float32))
    whole = TS.ssd_scan(*args, 16, initial_state=h0)
    monkeypatch.setattr(TS, "GROUP_ELEMS", 2 * 3 * 16 * 16 * per_group)
    grouped = TS.ssd_scan(*args, 16, initial_state=h0)
    assert all(torch.equal(a, b) for a, b in zip(whole, grouped))


# ------------------------------------------------------------ the gradient
def _scan_loss_jax(args, chunk):
    y, s = JS.ssd_scan(*args, chunk)
    return jnp.sum(y * y) + jnp.sum(s)


OVERFLOW_ARGS = dict(seed=0, B=1, L=256, H=4, P=8, N=16)  # two chunks of 128


def test_reference_gradient_overflows_at_chunk_128():
    """The property the port designs out: on these inputs the reference's
    gradient is finite at chunk 16 and not at chunk 128 (dt and A_log's
    gradients)."""
    args = [jnp.asarray(a) for a in _scan_inputs(**OVERFLOW_ARGS)]
    g16 = jax.grad(_scan_loss_jax)(args, 16)
    g128 = jax.grad(_scan_loss_jax)(args, 128)
    assert all(np.isfinite(np.asarray(g)).all() for g in g16)
    assert not all(np.isfinite(np.asarray(g)).all() for g in g128)
    assert not np.isfinite(np.asarray(g128[1])).all()  # dt's


def test_port_gradient_finite_at_chunk_128_and_equal_to_reference_at_16():
    np_args = _scan_inputs(**OVERFLOW_ARGS)
    want = jax.grad(_scan_loss_jax)([jnp.asarray(a) for a in np_args], 16)
    leaves = [torch.tensor(a, requires_grad=True) for a in np_args]
    y, s = TS.ssd_scan(*leaves, 128)
    got = torch.autograd.grad((y * y).sum() + s.sum(), leaves)
    for name, g, w in zip(("xh", "dt", "A_log", "Bm", "Cm"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, GRAD_TOL)


def test_masked_exponent_changes_no_bit_of_the_forward(monkeypatch):
    """The port's scan at chunk 128 against the same scan with the
    reference's form of the decay matrix (exp over every pair, then the
    pairs above the diagonal dropped): bit-equal; and against the
    reference's own scan within float32's tolerance."""
    np_args = _scan_inputs(**OVERFLOW_ARGS)
    args = [torch.tensor(a) for a in np_args]
    masked = TS.ssd_scan(*args, 128)

    def reference_form(ac):
        a = ac.transpose(-1, -2)
        seg = a[..., :, None] - a[..., None, :]
        Q = ac.shape[-2]
        tri = torch.ones((Q, Q), dtype=torch.bool).tril()
        return torch.where(tri, torch.exp(seg), torch.zeros((), dtype=seg.dtype))

    ac = torch.cumsum((args[1] * -torch.exp(args[2])).reshape(1, 2, 128, 4), dim=2)
    a = ac.transpose(-1, -2)
    assert torch.isinf(torch.exp(a[..., :, None] - a[..., None, :])).any()  # the overflow
    assert torch.equal(TS._decay_matrix(ac), reference_form(ac))
    monkeypatch.setattr(TS, "_decay_matrix", reference_form)
    unmasked = TS.ssd_scan(*args, 128)
    assert all(torch.equal(a, b) for a, b in zip(masked, unmasked))
    jy, js = JS.ssd_scan(*(jnp.asarray(a) for a in np_args), 128)
    _close(masked[0], jy)
    _close(masked[1], js)


# ------------------------------------------------------------ the layer
@pytest.fixture(scope="module")
def layer():
    jcfg = dataclasses.replace(jax_config("mamba2-130m").smoke(), ssm_chunk=8)
    tcfg = dataclasses.replace(get_config("mamba2-130m").smoke(), ssm_chunk=8)
    jp = JS.init_ssm(jax.random.PRNGKey(7), jcfg)
    tp = params_from_numpy(tcfg, {"embed": np.zeros(1), "layers": {"ssm": jax.device_get(jp)},
                                  "final_norm": np.zeros(1)}, "cpu")["layers"]["ssm"]
    return jcfg, tcfg, jp, tp


def test_ssm_params_keep_float32_leaves(layer):
    jcfg, tcfg, jp, tp = layer
    bf = dataclasses.replace(tcfg, param_dtype="bfloat16")
    p = TS.init_ssm(torch.Generator().manual_seed(0), bf, "cpu", (3,))
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32 and tp[name].dtype == torch.float32, name
        assert p[name].shape == (3, bf.ssm_heads)
    assert p["in_proj"].dtype == torch.bfloat16
    sp = torch.nn.functional.softplus(p["dt_bias"])
    assert float(sp.min()) >= 1e-3 * (1 - 1e-5) and float(sp.max()) <= 1e-1 * (1 + 1e-5)
    assert float(torch.exp(p["A_log"]).min()) >= 1.0 and float(torch.exp(p["A_log"]).max()) <= 16.0


@pytest.mark.parametrize("L", [2, 29])
def test_ssm_forward_with_cache_tail(layer, L):
    """The full-sequence layer and its cache: the conv tail of the last W-1
    raw inputs, zero-padded on the left when L < W-1 (L = 2 < 3)."""
    jcfg, tcfg, jp, tp = layer
    x = np.random.default_rng(L).normal(size=(2, L, jcfg.d_model)).astype(np.float32)
    jo, jc = JS.ssm_forward(jp, jnp.asarray(x), jcfg, cache=JS.init_ssm_cache(jcfg, 2))
    to, tc = TS.ssm_forward(tp, torch.tensor(x), tcfg, with_cache=True)
    _close(to, jo)
    _close(tc.conv, jc.conv)
    _close(tc.state, jc.state)
    assert TS.ssm_forward(tp, torch.tensor(x), tcfg)[1] is None


def test_ssd_chunk_flag_overrides_the_config(layer):
    jcfg, tcfg, jp, tp = layer
    x = np.random.default_rng(2).normal(size=(1, 24, jcfg.d_model)).astype(np.float32)
    assert TS.ssd_chunk(tcfg) == 8
    with tuning.tuned(ssd_chunk=4), jtuning.tuned(ssd_chunk=4):
        assert TS.ssd_chunk(tcfg) == 4
        _close(TS.ssm_forward(tp, torch.tensor(x), tcfg)[0],
               JS.ssm_forward(jp, jnp.asarray(x), jcfg)[0])


def test_ssm_decode_steps_match_reference(layer):
    """Eight recurrent steps from a prefilled cache; the port writes the
    cache in place, so it is compared after every step."""
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    _, jc = JS.ssm_forward(jp, jnp.asarray(x), jcfg, cache=JS.init_ssm_cache(jcfg, 2))
    _, tc = TS.ssm_forward(tp, torch.tensor(x), tcfg, with_cache=True)
    for i in range(8):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jo, jc = JS.ssm_decode_step(jp, jnp.asarray(xt), jc, jcfg)
        conv_before = tc.conv.clone()
        to = TS.ssm_decode_step(tp, torch.tensor(xt), tc, tcfg)
        _close(to, jo)
        _close(tc.conv, jc.conv)
        _close(tc.state, jc.state)
        assert torch.equal(tc.conv[:, :-1], conv_before[:, 1:])  # the window shifted in place


def test_ssm_cache_dtypes(layer):
    jcfg, tcfg, jp, tp = layer
    bf = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    c = TS.init_ssm_cache(bf, 3, (2,), "cpu")
    assert c.conv.shape == (2, 3, bf.ssm_conv_width - 1, bf.ssm_d_inner + 2 * bf.ssm_state)
    assert c.conv.dtype == torch.bfloat16 and c.state.dtype == torch.float32
    assert c.state.shape == (2, 3, bf.ssm_heads, bf.ssm_head_dim, bf.ssm_state)
