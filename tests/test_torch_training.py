"""The port's training stack against the JAX package on the CPU: the
learning-rate schedule, the decay mask, AdamW on carried state, int8
gradient compression, five train steps (microbatch 1 and 2, with and
without compression) from the same state, and the reference's optimizer,
compression and microbatching tests run on the port.

State crosses from the reference through ``state_from_numpy``. Tolerances:
the schedule and AdamW's scalars 1 ulp-scale (2e-7 relative); losses 1e-5
relative. After five steps without compression parameters agree within
1e-4 (an element whose gradient is near zero may take an Adam step of
another size), m within 1e-7 and v within 1e-8. With compression, a value
that sits on a rounding boundary of the int8 grid may round the other way
in the other package, so the error buffer agrees within one quantisation
step per element and parameters within 2e-3, m within 2e-4, v within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.training import grad_compression as jgc
from repro.training import optimizer as jopt
from repro.training.train_state import init_train_state as jax_init_state
from repro.training.train_state import make_train_step as jax_make_step
from _mesh_worker import run_ranks
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import grad_compression as gc
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import AdamWConfig, named_leaves
from repro_torch.training.train_state import (
    init_train_state,
    make_eval_step,
    make_train_step,
    state_from_numpy,
)

LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def smoke_cfg():
    return get_config("qwen2.5-3b").smoke()


def _leaves_np(tree):
    return [t.detach().float().numpy() for _, t in named_leaves(tree)]


def _batch(cfg, seed=0, B=2, S=16):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S))),
            "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))}


# ------------------------------------------------------------ schedule, mask, AdamW
def test_lr_schedule_matches_reference():
    for cfg in (AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
                AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=7),
                AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=12)):
        jcfg = jopt.AdamWConfig(*cfg)
        for s in (0, 1, 2, 3, 5, 7, 10, 11, 12, 37, 50, 99, 100, 150):
            want = float(jopt.lr_schedule(jcfg, jnp.asarray(s, jnp.int32)))
            got = opt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=2e-7, abs=0), (cfg, s)


def test_decay_mask_matches_reference_leaf_by_leaf():
    for name in ("qwen2.5-3b", "qwen2-moe-a2.7b", "chameleon-34b", "nemotron-4-15b"):
        jparams = jax.device_get(jax_init_state(jax_config(name).smoke(),
                                                jax.random.PRNGKey(0)).params)
        want = [jopt._decay_mask(p) for p, _ in jax.tree_util.tree_leaves_with_path(jparams)]
        tparams = params_from_numpy(get_config(name).smoke(), jparams, "cpu")
        got = [opt._decay_mask(p) for p, _ in named_leaves(tparams)]
        assert got == want, name
        assert True in got and False in got


def test_adamw_update_on_carried_state_matches_reference():
    """Three AdamW steps on random params, grads and moments (step 4 on),
    with and without clipping, leaves of several ranks."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (40, 8), "final_norm": (8,),
              "layers": {"attn": {"w_q": (2, 8, 8), "b_q": (2, 8)}, "mlp_norm": (2, 8)}}

    def draw(scale):
        return opt.tree_map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes)

    for clip in (1.0, 1e-3):
        cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
        p, m, v = draw(1.0), draw(0.1), opt.tree_map(np.abs, draw(0.01))
        jstate = jopt.OptState(m=m, v=v, step=jnp.asarray(4, jnp.int32))
        tp = opt.tree_map(torch.tensor, p)
        tstate = opt.OptState(m=opt.tree_map(torch.tensor, m), v=opt.tree_map(torch.tensor, v),
                              step=torch.tensor(4, dtype=torch.int32))
        jp = p
        for _ in range(3):
            g = draw(1.0)
            jp, jstate, jm = jopt.adamw_update(jopt.AdamWConfig(*cfg), jp, g, jstate)
            tp, tstate, tm = opt.adamw_update(cfg, tp, opt.tree_map(torch.tensor, g), tstate)
            assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
            assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=2e-7)
        assert int(tstate.step) == int(jstate.step) == 7
        for t, j in ((tp, jp), (tstate.m, jstate.m), (tstate.v, jstate.v)):
            for a, b in zip(_leaves_np(t), jax.tree_util.tree_leaves(jax.device_get(j))):
                np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-7)


def test_adamw_updates_in_slabs_as_one(monkeypatch):
    """A leaf larger than a slab is updated slab by slab along its leading
    axis: the same bits as one whole-leaf update."""
    rng = np.random.default_rng(1)
    p = {"w": torch.tensor(rng.normal(size=(5, 7, 3)).astype(np.float32))}
    g = {"w": torch.tensor(rng.normal(size=(5, 7, 3)).astype(np.float32))}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    out = []
    for slab in (1 << 26, 21, 40):
        monkeypatch.setattr(opt, "SLAB_ELEMS", slab)
        pp = {"w": p["w"].clone()}
        st = opt.init_opt_state(pp)
        for _ in range(2):
            pp, st, _ = opt.adamw_update(cfg, pp, g, st)
        out.append((pp["w"], st.m["w"], st.v["w"]))
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)


# ------------------------------------------------------------ compression
def test_compress_decompress_matches_reference_bit_for_bit(tmp_path):
    rng = np.random.default_rng(2)
    g = {"w": rng.normal(size=(64, 48)).astype(np.float32),
         "b": (rng.normal(size=(48,)) * 1e-3).astype(np.float32)}
    je, te = jgc.init_error_buf(g), gc.init_error_buf(opt.tree_map(torch.tensor, g))
    for _ in range(3):
        jd, je = jgc.compress_decompress(g, je)
        td, te = gc.compress_decompress(opt.tree_map(torch.tensor, g), te)
        for t, j in ((td, jd), (te, je)):
            for a, b in zip(_leaves_np(t), jax.tree_util.tree_leaves(jax.device_get(j))):
                assert np.array_equal(a, b)
    q, scale = gc._quant(torch.tensor([0.5, -1.5, 2.5, 127.0]))
    assert q.dtype == torch.int8 and q.tolist() == [0, -2, 2, 127]  # half to even
    # the int8-wire all-reduce over a one-rank group (a process of its own:
    # a process group is process-global) is the reference's on one device
    np.savez(tmp_path / "g.npz", w=g["w"])
    (ours,) = run_ranks("int8", 1, tmp_path, str(tmp_path / "g.npz"))
    mesh = jax.make_mesh((1,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    ref = jgc.shardmap_int8_psum(mesh, ("data",))(g["w"])
    assert np.array_equal(np.asarray(ours["full"][0], np.float32), np.asarray(ref))


def test_error_feedback_preserves_sum():
    """The reference's test on the port."""
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=(64, 64)), dtype=torch.float32)}
    e = gc.init_error_buf(g)
    total = torch.zeros_like(g["w"])
    for _ in range(30):
        deq, e = gc.compress_decompress(g, e)
        total = total + deq["w"]
    assert float(torch.max(torch.abs(total / 30 - g["w"]))) < 0.02


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("microbatch,compress", [(1, False), (2, False), (1, True), (2, True)])
def test_train_steps_match_reference(arch, microbatch, compress):
    jcfg, tcfg = jax_config(arch).smoke(), get_config(arch).smoke()
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(0), compress_grads=compress)
    tstate = state_from_numpy(tcfg, jax.device_get(jstate), "cpu")
    kw = dict(compress_grads=compress, microbatch=microbatch)
    jstep = jax.jit(jax_make_step(jcfg, jopt.AdamWConfig(lr=1e-3, warmup_steps=2), **kw))
    tstep = make_train_step(tcfg, AdamWConfig(lr=1e-3, warmup_steps=2), **kw)
    data = JaxTokens(JaxDataConfig(jcfg.vocab_size, 16, 4, seed=3))
    for s in range(5):
        b = data.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v) for k, v in b.items()})
        for k in ("loss", "ce", "aux", "tokens"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_TOL, abs=1e-7), (s, k)
        assert float(tm["lr"]) == float(jm["lr"])
    jd = jax.device_get(jstate)
    assert int(tstate.opt.step) == int(jd.opt.step) == 5
    tols = {"params": 2e-3, "m": 2e-4, "v": 2e-5} if compress else \
        {"params": 1e-4, "m": 1e-7, "v": 1e-8}
    for name, t, j in (("params", tstate.params, jd.params), ("m", tstate.opt.m, jd.opt.m),
                       ("v", tstate.opt.v, jd.opt.v)):
        for a, b in zip(_leaves_np(t), jax.tree_util.tree_leaves(j)):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=tols[name], rtol=0,
                                       err_msg=name)
    if compress:
        for a, b in zip(_leaves_np(tstate.error_buf), jax.tree_util.tree_leaves(jd.error_buf)):
            step = 2 * np.abs(b).max() + 1e-12  # |err| <= half a step, so a step >= 2 max|err|
            assert np.abs(a - b).max() <= 1.01 * step
    else:
        assert tstate.error_buf is None


def test_eval_step_matches_loss(smoke_cfg):
    state = init_train_state(smoke_cfg, 0, device="cpu")
    b = _batch(smoke_cfg, 4)
    m = make_eval_step(smoke_cfg)(state.params, b)
    _, tm = make_train_step(smoke_cfg, AdamWConfig())(state, b)
    assert float(m["ce"]) == pytest.approx(float(tm["ce"]), rel=1e-6)
    assert not m["ce"].requires_grad


# ------------------------------------------------------------ the reference's tests
class TestOptimizer:
    def test_lr_schedule_shape(self):
        cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        lrs = [float(opt.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
               for s in [0, 5, 10, 50, 100]]
        assert lrs[0] == 0.0
        assert lrs[1] == pytest.approx(5e-4)
        assert lrs[2] == pytest.approx(1e-3)
        assert lrs[3] < lrs[2]
        assert lrs[4] == pytest.approx(1e-4, rel=1e-2)

    def test_loss_decreases(self, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, device="cpu")
        step = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50))
        batch = _batch(smoke_cfg)  # overfit one batch
        losses = []
        for _ in range(15):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0] - 0.2, f"no learning: {losses[0]:.3f}->{losses[-1]:.3f}"
        assert np.isfinite(losses).all()

    def test_grad_clipping_bounds_update(self, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, device="cpu")
        before = _leaves_np(state.params)
        s2, _ = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3, grad_clip=1e-9))(
            state, _batch(smoke_cfg))
        d = max(float(np.max(np.abs(a - b))) for a, b in zip(before, _leaves_np(s2.params)))
        assert d < 1e-2

    def test_compressed_training_still_learns(self, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, compress_grads=True, device="cpu")
        step = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                               compress_grads=True)
        batch = _batch(smoke_cfg)
        losses = []
        for _ in range(12):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0] - 0.1


class TestMicrobatching:
    def test_grad_accumulation_matches_full_batch(self, smoke_cfg):
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
        batch = _batch(smoke_cfg, seed=9, B=4, S=16)
        s_full, m_full = make_train_step(smoke_cfg, opt_cfg)(
            init_train_state(smoke_cfg, 0, device="cpu"), batch)
        s_mb, m_mb = make_train_step(smoke_cfg, opt_cfg, microbatch=2)(
            init_train_state(smoke_cfg, 0, device="cpu"), batch)
        assert float(m_mb["loss"]) == pytest.approx(float(m_full["loss"]), rel=1e-4)
        for a, b in zip(_leaves_np(s_full.params), _leaves_np(s_mb.params)):
            np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-4)

    def test_microbatch_still_learns(self, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, device="cpu")
        step = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3), microbatch=2)
        batch = _batch(smoke_cfg, B=4, S=16)
        losses = []
        for _ in range(10):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.1

    def test_microbatch_must_divide_the_batch(self, smoke_cfg):
        step = make_train_step(smoke_cfg, AdamWConfig(), microbatch=3)
        with pytest.raises(ValueError, match="does not split"):
            step(init_train_state(smoke_cfg, 0, device="cpu"), _batch(smoke_cfg, B=4))
