"""The port's memory analysis (``repro_torch.analysis.memory``): the live
bytes of one call, followed by ``hlo_cost.CostCounter`` in its one pass.

* Hand counts: an allocation, a view (adds 0), an in-place operation (adds
  0), a ``del`` that frees before the next allocation, outputs that alias
  an argument (add 0), and a backward that frees its saved tensors; every
  storage a block of the CUDA caching allocator (512-byte multiples).
* Real and fake: a 2-layer train step and prefill of qwen2.5-3b and of
  mamba2-130m reach the same peak on CPU tensors and on ``FakeTensorMode``
  tensors.
* The kernel entry points report their analytic outputs plus workspace
  (``ops.*_workspace``), and the plain versions' temporaries do not show;
  ``page_copy.workspace_growth`` is the growth that ``_Workspace.fit``
  allocates, cold, grown and warm.
* Against the reference: ``argument_bytes`` equals XLA's
  ``memory_analysis().argument_size_in_bytes`` of the same smoke train step
  compiled for the CPU, and ``output_bytes`` its ``output_size_in_bytes``
  less the output tuple's index table (8 bytes a leaf). ``temp_bytes`` is
  not compared: XLA's is the fused program's buffer assignment, eager
  PyTorch's is one buffer an operation.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.training.optimizer import AdamWConfig as JaxAdamW
from repro.training.train_state import init_train_state as jax_init_state
from repro.training.train_state import make_train_step as jax_make_step
from repro_torch.analysis.hlo_cost import CostCounter
from repro_torch.analysis.memory import LiveBytes, block_bytes, memory_analysis
from repro_torch.configs import get_config
from repro_torch.kernels import ops, page_copy
from repro_torch.kernels.paged_attention import split_plan
from repro_torch.models import ssm_lm, transformer
from repro_torch.models.model import get_model
from repro_torch.training import train_state as ts
from repro_torch.training.optimizer import AdamWConfig

N = 1000  # float32 elements: 4,000 bytes, one 4,096-byte block
BLOCK = 4096
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def test_block_bytes_rounds_to_the_allocator_granularity():
    assert [block_bytes(n) for n in (0, 1, 512, 513, 4000)] == [0, 512, 512, 1024, 4096]


# ------------------------------------------------------------------ hand counts
def _alloc(x):
    return x * 2


def _view(x):
    a = x * 2
    return a[10:].view(-1, 10).t()


def _in_place(x):
    a = x * 2
    a.add_(1).mul_(3)
    return a


def _del_frees(x):
    a = x * 2
    b = a + 1
    del a
    return b * 3  # a was freed: b and c live, never three


def _alias(x):
    return x.view(10, -1), x.add_(1), x[5:]


@pytest.mark.parametrize("fn,temp,out", [
    (_alloc, BLOCK, 4 * N),
    (_view, BLOCK, 4 * (N - 10)),
    (_in_place, BLOCK, 4 * N),
    (_del_frees, 2 * BLOCK, 4 * N),
    (_alias, 0, 4 * (2 * N + N - 5)),
], ids=["allocation", "view", "in-place", "del", "aliasing-outputs"])
def test_hand_counted_chains(fn, temp, out):
    r = memory_analysis(fn, torch.randn(N))
    assert (r.argument_bytes, r.output_bytes, r.temp_bytes) == (4 * N, out, temp)
    assert r.peak_bytes == r.argument_bytes + temp


def test_backward_frees_its_saved_tensors():
    """h = x @ w [32, 64] f32 (8,192 bytes), y = tanh(h) (saved by its
    backward; h freed), l = sum(y) (512). The backward: the seed 1 (512,
    held by ``backward()`` to its end), tanh's gradient g (8,192); tanh's
    node then frees y; mm's gradient for w (16,384) is stolen into
    ``w.grad``. Highest: l, the seed, g and w's gradient = 25,600, where
    keeping y would give 33,792."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 64, generator=g).requires_grad_()
    x = torch.randn(32, 64, generator=g)

    def step(w, x):
        (x @ w).tanh().sum().backward()

    r = memory_analysis(step, w, x)
    assert r.temp_bytes == 512 + 512 + 8192 + 16384
    assert w.grad is not None


def test_other_devices_are_not_followed():
    with CostCounter(device="meta") as counter:
        torch.randn(N) * 2
    assert counter.live.peak == 0


# --------------------------------------------------------------- real and fake
def _two_layers(arch):
    return dataclasses.replace(get_config(arch).smoke(), num_layers=2)


def _train_peak(cfg, fake: bool) -> int:
    step = ts.make_train_step(cfg, AdamWConfig(**OPT), remat="block")
    with FakeTensorMode() if fake else contextlib.nullcontext():
        state = ts.init_train_state(cfg, 0, device="cpu")
        tokens = torch.zeros((2, 32), dtype=torch.int32)
        return memory_analysis(step, state, {"tokens": tokens, "labels": tokens.clone()}).peak_bytes


def _prefill_peak(cfg, fake: bool) -> int:
    mod = transformer if cfg.family == "dense" else ssm_lm
    with FakeTensorMode() if fake else contextlib.nullcontext():
        params = get_model(cfg).init(seed=0, device="cpu")
        tokens = torch.zeros((2, 24), dtype=torch.int64)
        return memory_analysis(lambda p, t: mod.prefill(p, t, cfg, 32), params, tokens).peak_bytes


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_real_and_fake_peaks_equal(arch):
    cfg = _two_layers(arch)
    train = _train_peak(cfg, False)
    assert train == _train_peak(cfg, True)
    pre = _prefill_peak(cfg, False)
    assert pre == _prefill_peak(cfg, True)
    assert train > pre > 0


# ------------------------------------------------------------------ the kernels
def _attn_inputs(g):
    q = torch.randn(2, 8, 48, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 2, 64, 16, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 2, 64, 16, generator=g).to(torch.bfloat16)
    return q, k, v


def test_flash_attention_reports_its_output_only():
    q, k, v = _attn_inputs(torch.Generator().manual_seed(1))
    r = memory_analysis(ops.flash_attention, q, k, v)
    # the plain version's float32 scores alone are 2 x 8 x 48 x 64 x 4 bytes
    assert r.temp_bytes == block_bytes(q.nbytes) == 24576
    assert r.output_bytes == q.nbytes


def test_paged_attention_reports_output_and_partials():
    g = torch.Generator().manual_seed(2)
    B, nh, nkv, dh, page, n_p = 3, 8, 2, 16, 4, 5
    q = torch.randn(B, nh, dh, generator=g)
    kp = torch.randn(12, page, nkv, dh, generator=g)
    vp = torch.randn(12, page, nkv, dh, generator=g)
    tables = torch.randint(0, 12, (B, n_p), dtype=torch.int32, generator=g)
    lens = torch.tensor([9, 3, 20], dtype=torch.int32)
    n_split, _ = split_plan(B, nkv, n_p, 132)  # the H100's SMs off the card
    n_acc = B * nkv * n_split * (nh // nkv) * dh
    partials = 4 * (n_acc + n_acc // dh * 2)
    assert ops.paged_attention_workspace(q, kp, vp, tables, lens) == [partials, -partials]
    r = memory_analysis(ops.paged_attention, q, kp, vp, tables, lens)
    assert r.temp_bytes == block_bytes(q.nbytes) + block_bytes(partials)


def test_hot_bins_reports_its_two_outputs():
    g = torch.Generator().manual_seed(3)
    counts = torch.randint(0, 50, (3000,), dtype=torch.int32, generator=g)
    ids = torch.randint(0, 3000, (7000,), dtype=torch.int32, generator=g)
    r = memory_analysis(ops.hot_bins, ids, counts)
    assert r.temp_bytes == 2 * block_bytes(counts.nbytes)


def test_page_move_and_page_copy_hold_nothing_off_the_card():
    pool, staging = torch.randn(10, 32), torch.randn(4, 32)
    src = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    dst = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    assert memory_analysis(ops.page_move, pool, src, dst).temp_bytes == 0
    r = memory_analysis(ops.page_copy, staging, pool, torch.arange(4, dtype=torch.int32), dst)
    assert r.temp_bytes == 0


def test_kernel_inside_a_backward_reports_once():
    """An entry point called in a backward reports its output there: the
    gradient of q is ``flash_attention``'s output (stolen into q.grad)."""

    class AttnInBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(k, v)
            return q.clone()

        @staticmethod
        def backward(ctx, gq):
            k, v = ctx.saved_tensors
            return ops.flash_attention(gq, k, v), None, None

    q, k, v = _attn_inputs(torch.Generator().manual_seed(4))
    q.requires_grad_()

    def run(q, k, v):
        AttnInBackward.apply(q, k, v).sum().backward()

    r = memory_analysis(run, q, k, v)
    b = block_bytes(q.nbytes)
    # the clone is freed once summed (the sum's backward keeps no input);
    # the sum (512) and the seed (512) live when the kernel's output is made
    assert r.temp_bytes == max(b + 512, 512 + 512 + b)


@pytest.mark.parametrize("calls,cold", [
    ([(4, 3, 64)], 1024 + 4 * 512),  # the counter words, then four small buffers
    ([(4, 3, 64), (9, 300, 64)], None),  # grown: each new buffer beside the one it replaces
    ([(9, 6, 64), (4, 3, 64)], 0),  # warm: nothing
    ([(300, 200, 2048), (300, 2000, 4096)], None),  # blocks over 512 bytes
], ids=["cold", "grown", "warm", "large"])
def test_workspace_growth_is_what_fit_allocates(calls, cold, monkeypatch):
    """``workspace_growth`` against ``_Workspace.fit`` itself, followed by
    the tracker on the CPU (a ``_Workspace`` allocates there as on the card,
    and the tracker counts the caching allocator's blocks)."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(page_copy, "_WORKSPACES", {})
    *earlier, (rows, m, row_bytes) = calls
    with CostCounter(device=cpu) as counter:  # follows the earlier buffers too
        for args in earlier:
            page_copy._WORKSPACES.setdefault(cpu, page_copy._Workspace(cpu)).fit(*args)
        want = page_copy.workspace_growth(cpu, rows, m, row_bytes)
        live = counter.live
        before = live.peak = live.settled()
        ws = page_copy._WORKSPACES.get(cpu)
        if ws is None:
            ws = page_copy._WORKSPACES[cpu] = page_copy._Workspace(cpu)
        ws.fit(rows, m, row_bytes)
    replay = LiveBytes(None)
    replay.hold(*want)
    assert (replay.peak, replay.live) == (live.peak - before, live.settled() - before)
    if cold is not None:
        assert replay.peak == replay.live == cold
    else:
        assert replay.peak > replay.live > 0


# --------------------------------------------------------------- the reference
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_argument_and_output_bytes_equal_xla(arch):
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    B, S = 2, 16
    jstate = jax_init_state(jcfg, jax.random.PRNGKey(0))
    jbatch = {"tokens": jnp.zeros((B, S), jnp.int32), "labels": jnp.zeros((B, S), jnp.int32)}
    jstep = jax_make_step(jcfg, JaxAdamW(**OPT), remat="block")
    want = jax.jit(jstep).lower(jstate, jbatch).compile().memory_analysis()
    leaves = len(jax.tree_util.tree_leaves(jax.eval_shape(jstep, jstate, jbatch)))

    state = ts.init_train_state(cfg, 0, device="cpu")
    tokens = torch.zeros((B, S), dtype=torch.int32)
    got = memory_analysis(ts.make_train_step(cfg, AdamWConfig(**OPT), remat="block"), state,
                          {"tokens": tokens, "labels": tokens.clone()})
    assert got.argument_bytes == want.argument_size_in_bytes
    assert got.output_bytes == want.output_size_in_bytes - 8 * leaves
    assert got.peak_bytes == got.argument_bytes + got.temp_bytes
