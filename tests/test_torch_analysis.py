"""The port's cost-analysis layer (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

* ``roofline``: ``model_flops_per_step`` equal to the reference's for every
  arch x applicable shape x {1, 4, 256} chips (the same float64 arithmetic:
  exact); ``tests/test_analysis.py::TestRoofline`` on the port, with the
  port's H100 constants.
* ``hlo_cost.module_cost``: ``TestHloCost``'s programs (a scan of L
  products written as a Python loop, nested loops, a batched einsum) count
  the reference's FLOPs on its compiled HLO exactly; its slicing rule holds
  on the port's bytes (a slice reads its slice, a gather its result, a
  scatter its update twice); functional collectives count their result
  bytes by kind. A smoke train step counts the reference's FLOPs on its
  CPU-compiled HLO plus the port's one extra product, the loss chunks'
  recompute (``chunked_ce_loss`` checkpoints each chunk; the reference's
  scan keeps the logits): 2 B S d V, exact for qwen2.5-3b and within 0.3%
  for the SSM families, whose SSD einsums XLA contracts in another order.
  Bytes are eager PyTorch's against XLA's fused HLO: printed, not held.
* The kernels' counts: a ``flash_attention`` call, and a prefill through
  it, count the same FLOPs, bytes and calls whether the plain version runs
  or a stand-in for the CUDA kernel (launched outside any dispatch mode, as
  the ctypes launch is), and equal the analytic formula; ``page_move`` and
  ``paged_attention`` count what their data needs.
* ``attribution``: contributions add up to ``module_cost``'s totals, are
  named by the port's function path, and carry result types that
  ``kernel_adjusted_bytes``' regex reads.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.analysis import hlo_cost as JH
from repro.analysis import roofline as JR
from repro.configs import ARCH_NAMES
from repro.configs import applicable_shapes as jax_applicable_shapes
from repro.configs import get_config as jax_get_config
from repro.training.optimizer import AdamWConfig as JaxAdamW
from repro.training.train_state import init_train_state as jax_init_state
from repro.training.train_state import make_train_step as jax_make_step
from repro_torch.analysis import attribution as A
from repro_torch.analysis import hlo_cost as H
from repro_torch.analysis import roofline as R
from repro_torch.configs import applicable_shapes, get_config, get_shape
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer
from repro_torch.models.model import get_model
from repro_torch.training import train_state as ts
from repro_torch.training.optimizer import AdamWConfig


def _jax_flops(f, *shapes) -> float:
    return JH.module_cost(jax.jit(f).lower(*shapes).compile().as_text()).flops


# ------------------------------------------------------------------ TestHloCost
@pytest.mark.parametrize("L", [1, 3, 7])
def test_scan_trip_count_multiplies_flops(L):
    def jf(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=L)[0]

    def tf(x, w):
        c = x
        for _ in range(L):
            c = torch.tanh(c @ w)
        return c

    want = _jax_flops(jf, jax.ShapeDtypeStruct((64, 128), jnp.float32),
                      jax.ShapeDtypeStruct((128, 128), jnp.float32))
    got = H.module_cost(tf, torch.randn(64, 128), torch.randn(128, 128))
    assert got.flops == want == 2 * 64 * 128 * 128 * L


def test_nested_scan_trip_counts_compose():
    def jf(x, w):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    def tf(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    want = _jax_flops(jf, jax.ShapeDtypeStruct((32, 64), jnp.float32),
                      jax.ShapeDtypeStruct((64, 64), jnp.float32))
    got = H.module_cost(tf, torch.randn(32, 64), torch.randn(64, 64))
    assert got.flops == want == 2 * 32 * 64 * 64 * 12


def test_dot_flops_from_contracting_dims():
    want = _jax_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                      jax.ShapeDtypeStruct((4, 8, 16), jnp.float32),
                      jax.ShapeDtypeStruct((4, 16, 32), jnp.float32))
    got = H.module_cost(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                        torch.randn(4, 8, 16), torch.randn(4, 16, 32))
    assert got.flops == want == 2 * 4 * 8 * 32 * 16


def test_bytes_slicing_semantics():
    """A slice of a stacked buffer reads only its slice (the scan pattern);
    its type reads as the reference's HLO shape string."""
    buf = torch.zeros(16, 8, 128, dtype=torch.bfloat16)
    assert H.rtype(buf[3]) == "bf16[8,128]"
    assert JH.shape_elems_bytes("bf16[8,128]{1,0}") == (1024, 2048)
    c = H.module_cost(lambda x: x[3] * 2, buf)
    assert c.bytes == 2048 + 2048 and c.flops == 0  # read the slice, write the result
    idx = torch.tensor([1, 5])
    assert H.module_cost(lambda x: x.index_select(0, idx), buf).bytes == 2 * 2 * 8 * 128 * 2
    upd = torch.ones(2, 8, 128, dtype=torch.bfloat16)
    assert H.module_cost(lambda x: x.index_copy_(0, idx, upd), buf).bytes == 2 * upd.nbytes
    assert H.module_cost(lambda x: torch.empty_like(x), buf).bytes == 0


def test_collective_bytes_by_kind():
    """Functional collectives over a 4-rank fake process group in this one
    process: result bytes by kind."""
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        x = torch.ones(8, 16)

        def step(x):
            a = funcol.wait_tensor(funcol.all_reduce(x, "sum", dist.group.WORLD))
            g = funcol.wait_tensor(funcol.all_gather_tensor(a, 0, dist.group.WORLD))
            return funcol.wait_tensor(funcol.reduce_scatter_tensor(g, "sum", 0,
                                                                   dist.group.WORLD))

        c = H.module_cost(step, x)
    finally:
        dist.destroy_process_group()
    assert dict(c.coll_bytes) == {"all-reduce": 512.0, "all-gather": 2048.0,
                                  "reduce-scatter": 512.0}
    assert dict(c.coll_counts) == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
    assert c.coll_total == 3072.0 and c.scaled(2).coll_total == 6144.0


# ------------------------------------------------------------------ TestRoofline
def test_terms_and_dominance():
    cfg, shape = get_config("yi-6b"), get_shape("train_4k")
    t = R.compute_terms(cfg, shape, 256, flops_per_device=1e15, bytes_per_device=1e13,
                        collective_bytes_dev=1e11)
    assert t.compute_s == pytest.approx(1e15 / R.PEAK_FLOPS)
    assert t.memory_s == 1e13 / R.HBM_BW and t.collective_s == 1e11 / R.NVLINK_BW
    assert t.dominant == "memory"
    assert 0 < t.roofline_fraction <= 1
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.HBM_BYTES) == (989e12, 3.35e12, 450e9,
                                                                   80 << 30)


def test_model_flops_train_scales_with_tokens():
    cfg = get_config("qwen2.5-3b")
    f_train = R.model_flops_per_step(cfg, get_shape("train_4k"), 256)
    f_decode = R.model_flops_per_step(cfg, get_shape("decode_32k"), 256)
    assert f_train > 1000 * f_decode
    assert f_train >= 6.0 * cfg.active_param_count() * 256 * 4096


def test_moe_uses_active_params():
    cfg = get_config("moonshot-v1-16b-a3b")
    assert cfg.active_param_count() < 0.3 * cfg.param_count()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = applicable_shapes(cfg)
    assert shapes
    for shape in shapes:
        jshape = next(s for s in jax_applicable_shapes(jcfg) if s.name == shape.name)
        for n in (1, 4, 256):
            got = R.model_flops_per_step(cfg, shape, n)
            assert got == JR.model_flops_per_step(jcfg, jshape, n), (shape.name, n)
            t = R.compute_terms(cfg, shape, n, 1e15, 1e12, 1e9)
            assert t.model_flops == got
            assert t.useful_ratio == min(got / max(1e15 * n, 1.0), 1.0)


# ------------------------------------------------------------ a train step
def _train_flops(arch, B, S):
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    state = jax_init_state(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32)}
    want = JH.module_cost(jax.jit(jax_make_step(jcfg, JaxAdamW(**opt), remat="block"))
                          .lower(state, batch).compile().as_text())
    tstate = ts.init_train_state(cfg, 0, device="cpu")
    tbatch = {"tokens": torch.zeros((B, S), dtype=torch.int64),
              "labels": torch.zeros((B, S), dtype=torch.int64)}
    got = H.module_cost(ts.make_train_step(cfg, AdamWConfig(**opt), remat="block"),
                        tstate, tbatch)
    print(f"{arch} B={B} S={S}: flops port {got.flops:.0f} reference {want.flops:.0f}; "
          f"bytes port {got.bytes:.0f} reference {want.bytes:.0f} (not comparable)")
    return cfg, got, want


@pytest.mark.parametrize("S", [16, 64])
def test_train_step_flops_equal_reference_plus_ce_recompute(S):
    cfg, got, want = _train_flops("qwen2.5-3b", 2, S)
    ce_recompute = 2 * 2 * S * cfg.d_model * cfg.vocab_size
    assert got.flops - ce_recompute == want.flops
    assert got.kernel_flops == 0 and not got.kernel_calls  # the step launches no kernel


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_train_step_flops_within_2pct(arch):
    cfg, got, want = _train_flops(arch, 2, 64)
    ce_recompute = 2 * 2 * 64 * cfg.d_model * cfg.vocab_size
    assert abs(got.flops - ce_recompute - want.flops) <= 0.02 * want.flops


# -------------------------------------------------------------- the kernels
def _stub_kernel(monkeypatch):
    """Stand in for the CUDA kernel on CPU tensors: ``ops`` takes its
    kernel branch, and the stand-in computes outside any dispatch mode (as
    the ctypes launch does) with other operations than the plain version,
    counting its launches as the wrapper does."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)

    def fake(q, k, v, *, causal=True, sliding_window=0):
        with torch.utils._python_dispatch._disable_current_modes():
            out = ref.flash_attention_ref(q.double(), k.double(), v.double(), causal=causal,
                                          sliding_window=sliding_window).to(q.dtype)
        _fa.LAUNCHES["flash_attention"] += 1
        return out

    monkeypatch.setattr(_fa, "flash_attention", fake)


def _count(fn, *args):
    c = H.module_cost(fn, *args)
    return c.flops, c.bytes, c.kernel_flops, c.kernel_bytes, dict(c.kernel_calls)


@pytest.mark.parametrize("nh,nkv,Sq,Skv,causal,window", [
    (8, 2, 64, 64, True, 0), (4, 4, 48, 80, True, 0), (4, 1, 64, 64, True, 24),
    (6, 6, 9, 40, False, 0),
])
def test_flash_count_same_for_plain_and_kernel(nh, nkv, Sq, Skv, causal, window, monkeypatch):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, nh, Sq, 16, generator=g, dtype=torch.float32).to(torch.bfloat16)
    k = torch.randn(2, nkv, Skv, 16, generator=g).to(torch.bfloat16)
    v = torch.randn(2, nkv, Skv, 16, generator=g).to(torch.bfloat16)

    def call(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal, sliding_window=window)

    plain = _count(call, q, k, v)
    qpos = torch.arange(Sq)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones(Sq, Skv, dtype=torch.bool)
    if window:
        mask &= kpos > qpos - window
    flops = 4.0 * 2 * nh * 16 * int(mask.sum())
    nbytes = float(2 * q.nbytes + k.nbytes + v.nbytes)
    assert plain == (flops, nbytes, flops, nbytes, {"flash_attention": 1})
    _stub_kernel(monkeypatch)
    ops.reset_launch_counts()
    assert _count(call, q, k, v) == plain
    assert ops.launch_counts()["flash_attention"] == 1


def test_prefill_count_same_for_plain_and_kernel(monkeypatch):
    """A smoke model's prefill (every layer through ``flash_attention``):
    total FLOPs, kernel FLOPs and bytes, and calls equal for the plain
    version and the stand-in; the calls equal the launches."""
    cfg = get_config("qwen2.5-3b").smoke()
    params = get_model(cfg).init(seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))

    def run(p, t):
        return transformer.prefill(p, t, cfg, 32)

    plain = H.module_cost(run, params, tokens)
    _stub_kernel(monkeypatch)
    ops.reset_launch_counts()
    card = H.module_cost(run, params, tokens)
    assert card.kernel_calls == plain.kernel_calls == {"flash_attention": cfg.num_layers}
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    assert (card.flops, card.kernel_flops, card.kernel_bytes) == \
        (plain.flops, plain.kernel_flops, plain.kernel_bytes)
    pairs = ops.attention_pairs(24, 24, True, 0)
    assert pairs == 24 * 25 // 2
    assert card.kernel_flops == cfg.num_layers * 4.0 * 2 * cfg.num_heads * cfg.d_head * pairs


class _AttnInBackward(torch.autograd.Function):
    """Identity forward; the backward runs ``flash_attention`` (as a kernel
    called inside a backward would)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(k, v)
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        k, v = ctx.saved_tensors
        return ops.flash_attention(g, k, v), None, None


@pytest.mark.parametrize("stub", [False, True])
def test_kernel_counted_inside_a_backward(stub, monkeypatch):
    """The counter is found on the dispatch-mode stack, which the autograd
    engine carries into a backward: an entry point called there counts its
    analytic cost once (not its insides), in the backward, for the plain
    version and the stand-in alike."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 4, 32, 16, generator=g).to(torch.bfloat16).requires_grad_()
    k = torch.randn(2, 2, 32, 16, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 2, 32, 16, generator=g).to(torch.bfloat16)
    if stub:
        _stub_kernel(monkeypatch)

    def run(q, k, v):
        _AttnInBackward.apply(q, k, v).float().sum().backward()

    c = H.module_cost(run, q, k, v)
    flops, nbytes = ops.flash_attention_cost(q, k, v)
    assert (c.kernel_flops, c.kernel_bytes, dict(c.kernel_calls)) == \
        (flops, nbytes, {"flash_attention": 1})
    assert c.flops == flops  # the forward's clone and the sums count no FLOPs
    rows = A.attribute(run, q, k, v)
    kern = [r for r in rows if r.kind == "kernel"]
    assert len(kern) == 1 and kern[0].comp == "backward" and kern[0].flops == flops


def test_page_move_and_paged_attention_count_their_data():
    pool = torch.zeros(10, 32)  # 128-byte rows
    src = torch.tensor([1, 2, 3, 3, -1], dtype=torch.int32)
    dst = torch.tensor([4, 5, 3, 6, 7], dtype=torch.int32)  # 3 real: 3->3 and -1 are not
    c = H.module_cost(ops.page_move, pool, src, dst)
    assert (c.flops, c.bytes) == (0.0, 2 * 3 * 128 + 2 * 20)
    assert c.kernel_calls == {"page_move": 1}
    g = torch.Generator().manual_seed(2)
    q = torch.randn(3, 8, 16, generator=g)
    kp, vp = torch.randn(12, 4, 2, 16, generator=g), torch.randn(12, 4, 2, 16, generator=g)
    tables = torch.tensor([[0, 1, 2], [3, -1, -1], [4, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([9, 3, 12], dtype=torch.int32)  # valid keys: 9, 3, 12
    c = H.module_cost(ops.paged_attention, q, kp, vp, tables, lens)
    assert c.flops == 4 * 8 * 16 * 24
    assert c.bytes == 2 * 24 * 2 * 16 * 4 + 2 * q.nbytes + tables.nbytes + lens.nbytes


# --------------------------------------------------------------- attribution
def test_attribution_adds_up_and_names_the_code():
    cfg = get_config("qwen2.5-3b").smoke()
    state = ts.init_train_state(cfg, 0, device="cpu")
    step = ts.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int64),
             "labels": torch.zeros((2, 16), dtype=torch.int64)}
    total = H.module_cost(step, state, batch)
    rows = A.attribute(step, state, batch)
    assert sum(r.flops for r in rows) == total.flops
    assert sum(r.bytes for r in rows) == pytest.approx(total.bytes, rel=1e-12)
    assert {r.comp for r in rows} == {"forward", "backward"}
    assert any("transformer.block_full" in r.op_name for r in rows if r.comp == "forward")
    assert any(r.op_name.startswith("backward:") for r in rows if r.comp == "backward")
    assert all(len(r.op_name) <= 110 and len(r.rtype) <= 48 for r in rows)
    top = A.top(rows, "flops", 5)
    assert len(top) == 5 and top[0].flops == max(r.flops for r in rows)
    # kernel_adjusted_bytes reads the port's result types with its regex
    blk = [A.Contribution("forward", "aten.bmm.default", "bmm", "x", 0.0, 100.0, 0.0,
                          "f32[2,4,512,1024]"),
           A.Contribution("forward", "aten.mm.default", "mm", "y", 0.0, 50.0, 0.0,
                          "f32[512,64]")]
    counted, adjusted = A.kernel_adjusted_bytes(blk, get_config("yi-6b"), get_shape("train_4k"),
                                                256)
    assert counted == 150.0 and adjusted > 50.0
