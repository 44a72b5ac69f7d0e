"""The port's dense LM stack against the JAX package on the CPU, model by
model: for five architectures the loss with every gradient leaf, remat,
prefill + decode in both cache-commit branches, teacher forcing and the
deferred-commit equivalence (the layers are in ``test_torch_lm.py``).

Both sides run ``.smoke()`` configs in float32 with the same weights (the
reference's random init, carried into the port by ``params_from_numpy``)
and the same numpy-made inputs. Tolerances: the loss 1e-5 relative; each
gradient leaf 2e-5 of its largest entry (float32 sums in another order
through a few layers and the backward); logits 1e-4 and caches 1e-5, as
the serving slice's tests hold them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import tuning as jtuning
from repro.models.model import get_model as jax_model
from repro_torch.configs import get_config
from repro_torch.models import tuning
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import get_model
from repro_torch.models.transformer import KVCache
from repro_torch.training.optimizer import named_leaves, tree_map

ARCHS = ("qwen2.5-3b", "nemotron-4-15b", "chameleon-34b", "yi-6b", "qwen2-moe-a2.7b")
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jcfg, tcfg = jax_config(name).smoke(), get_config(name).smoke()
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.device_get(jparams), "cpu")
    return name, jcfg, tcfg, jparams, tparams


# ------------------------------------------------------------ models
def _batch(cfg, seed, B=2, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs[0, :3] = -1  # ignored labels
    return toks, labs


def test_loss_and_every_gradient_match_reference(arch):
    name, jcfg, tcfg, jparams, tparams = arch
    toks, labs = _batch(jcfg, 1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jax_model(jcfg).loss(p, jb), has_aux=True)(jparams)
    leaf = tree_map(lambda p: p.detach().requires_grad_(), tparams)
    tloss, tm = get_model(tcfg).loss(leaf, {"tokens": torch.tensor(toks),
                                            "labels": torch.tensor(labs)})
    flat = named_leaves(leaf)
    tg = torch.autograd.grad(tloss, [p for _, p in flat])
    _close(tloss, jloss, LOSS_TOL)
    for k in ("ce", "aux", "tokens"):
        _close(tm[k], jm[k], LOSS_TOL)
    assert float(tm["tokens"]) == float((labs >= 0).sum())
    if tcfg.is_moe:
        assert float(tm["aux"].detach()) > 0
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jg))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in flat]
    for (path, j), t in zip(jl, tg):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, atol=GRAD_TOL * max(np.abs(j).max(), 1e-6),
                                   rtol=0, err_msg=str(path))


def test_remat_does_not_change_the_loss(arch):
    name, jcfg, tcfg, jparams, tparams = arch
    toks, labs = _batch(jcfg, 2)
    b = {"tokens": torch.tensor(toks), "labels": torch.tensor(labs)}
    out = {}
    for remat in ("none", "block", "dots"):
        leaf = tree_map(lambda p: p.detach().requires_grad_(), tparams)
        loss, _ = get_model(tcfg).loss(leaf, b, remat=remat)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, [p for _, p in named_leaves(leaf)]))
    for remat in ("block", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, c in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, c)


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "eager"])
def test_prefill_and_decode_match_reference(arch, deferred):
    """Prefill of 8-token prompts into a 16-position cache, then 5 decode
    steps fed the same tokens in both packages: logits and caches."""
    name, jcfg, tcfg, jparams, tparams = arch
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    feed = rng.integers(1, jcfg.vocab_size, (5, 2)).astype(np.int32)
    japi, tapi = jax_model(jcfg), get_model(tcfg)
    jl, jc = japi.prefill(jparams, jnp.asarray(prompt), 16)
    tl, tc = tapi.prefill(tparams, torch.tensor(prompt), 16)
    _close(tl, jl, LOGIT_TOL)
    assert isinstance(tc, KVCache) and tc.pos == int(jc.pos) == 8
    with jtuning.tuned(decode_deferred_commit=deferred), \
            tuning.tuned(decode_deferred_commit=deferred):
        jstep = jax.jit(lambda p, t, c: japi.decode(p, t, c))
        for i in range(5):
            jl, jc = jstep(jparams, jnp.asarray(feed[i]), jc)
            tl, tc = tapi.decode(tparams, torch.tensor(feed[i]), tc)
            assert tl.shape == (2, jcfg.vocab_size) and tl.dtype == torch.float32
            _close(tl, jl, LOGIT_TOL)
    assert tc.pos == int(jc.pos) == 13
    _close(tc.k, jc.k, CACHE_TOL)
    _close(tc.v, jc.v, CACHE_TOL)


def _greedy_rollout(api, params, prompt, n, max_len):
    logits, cache = api.prefill(params, prompt, max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)
    toks = [tok]
    for _ in range(n - 1):
        logits, cache = api.decode(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def test_prefill_decode_matches_teacher_forcing(arch):
    """The reference's teacher-forcing test on the port: greedy decode of a
    prompt, then prefill of the prompt and all but the last generated token
    predicts the last one."""
    name, jcfg, tcfg, jparams, tparams = arch
    api = get_model(tcfg)
    prompt = torch.arange(1, 9)[None, :]
    out = _greedy_rollout(api, tparams, prompt, 4, max_len=16)
    logits2, _ = api.prefill(tparams, torch.cat([prompt, out[:, :-1]], dim=1), 16)
    assert int(torch.argmax(logits2[:, -1], dim=-1)[0]) == int(out[0, -1])


def test_deferred_commit_multi_step_equivalence(arch):
    """The reference's deferred-commit test on the port: three decode steps
    from an empty cache under each branch; logits and keys agree."""
    name, jcfg, tcfg, jparams, tparams = arch
    api = get_model(tcfg)
    toks = torch.tensor([[2, 9, 4]])

    def run():
        cache = api.init_cache(1, 8, device="cpu")
        outs = []
        for i in range(3):
            logits, cache = api.decode(tparams, toks[:, i], cache)
            outs.append(logits)
        return torch.stack(outs), cache

    with tuning.tuned(decode_deferred_commit=True):
        o_def, c_def = run()
    with tuning.tuned(decode_deferred_commit=False):
        o_eager, c_eager = run()
    _close(o_def, o_eager, 2e-4)
    _close(c_def.k, c_eager.k, 1e-5)
    assert c_def.pos == c_eager.pos == 3


def test_decode_refuses_a_full_cache():
    cfg = get_config("yi-6b").smoke()
    api = get_model(cfg)
    params = api.init(seed=0, device="cpu")
    cache = api.init_cache(1, 2, device="cpu")
    for t in range(2):
        _, cache = api.decode(params, torch.tensor([t]), cache)
    with pytest.raises(ValueError, match="full"):
        api.decode(params, torch.tensor([3]), cache)


def test_other_families_wait_for_their_item():
    """Every family of the reference is ported; an unknown family raises
    ``ValueError``, as the reference's ``get_model`` does."""
    for name in ("mamba2-130m", "zamba2-1.2b", "whisper-tiny"):
        cfg = get_config(name).smoke()
        assert get_model(cfg).cfg is cfg
    cfg = dataclasses.replace(get_config("yi-6b").smoke(), family="unknown")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(cfg)
    with pytest.raises(ValueError, match="unknown family"):
        jax_model(dataclasses.replace(jax_config("yi-6b").smoke(), family="unknown"))


def test_sliding_window_decode_follows_each_reference_branch():
    """A property of the reference that the port keeps: with a sliding
    window the deferred branch attends to the window's w cached tokens and
    the current one (w + 1), the eager branch to w including the current
    one. Each port branch matches the reference's same branch; the two
    branches differ once the context is longer than the window."""
    jcfg = dataclasses.replace(jax_config("yi-6b").smoke(), sliding_window=4)
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(), sliding_window=4)
    jparams = jax_model(jcfg).init(jax.random.PRNGKey(3))
    tparams = params_from_numpy(tcfg, jax.device_get(jparams), "cpu")
    prompt = np.random.default_rng(6).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    feed = np.random.default_rng(7).integers(1, jcfg.vocab_size, (3, 2)).astype(np.int32)
    logits = {}
    for deferred in (True, False):
        with jtuning.tuned(decode_deferred_commit=deferred), \
                tuning.tuned(decode_deferred_commit=deferred):
            japi, tapi = jax_model(jcfg), get_model(tcfg)
            _, jc = japi.prefill(jparams, jnp.asarray(prompt), 12)
            _, tc = tapi.prefill(tparams, torch.tensor(prompt), 12)
            jstep = jax.jit(lambda p, t, c: japi.decode(p, t, c))
            for i in range(3):
                jl, jc = jstep(jparams, jnp.asarray(feed[i]), jc)
                tl, tc = tapi.decode(tparams, torch.tensor(feed[i]), tc)
                _close(tl, jl, LOGIT_TOL)
        logits[deferred] = tl
    assert float((logits[True] - logits[False]).abs().max()) > 1e-3
