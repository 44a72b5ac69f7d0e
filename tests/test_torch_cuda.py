"""The port's CUDA kernels on the card: each hand-written kernel against its
plain PyTorch version, the copies and histograms bit for bit, attention
within the reference's tolerances. Every test here needs a CUDA device and
skips without one; the file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py tests/test_torch_isolation.py
"""
import numpy as np
import pytest
import torch

from _page_move_plans import FAMILIES, A, B, S
from repro_torch.kernels import ops, page_copy, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels compile and run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E", [33, 100, 257, 1024])
def test_cuda_page_move_matches_plain(cuda, E):
    rng = np.random.default_rng(E)
    rows, M = 4097, 512
    pool = torch.as_tensor(rng.normal(size=(rows, E)).astype(np.float32), device=cuda)
    perm = rng.permutation(rows - 1)
    src = perm[:M].copy()
    dst = perm[M : 2 * M].copy()
    dst[: M // 2] = src[M // 2 :]  # write-after-read pairs
    src[-8:] = dst[-8:] = rows - 1  # trash padding
    s = torch.as_tensor(src.astype(np.int32), device=cuda)
    d = torch.as_tensor(dst.astype(np.int32), device=cuda)
    want = ref.page_move_ref(pool.clone(), s, d)
    got = ops.page_move(pool.clone(), s, d)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("E", [33, 100, 257, 1024])
def test_cuda_page_copy_matches_plain(cuda, E):
    rng = np.random.default_rng(E + 1)
    rows, M = 2049, 300
    src_pool = torch.as_tensor(rng.normal(size=(M, E)).astype(np.float32), device=cuda)
    pool = torch.as_tensor(rng.normal(size=(rows, E)).astype(np.float32), device=cuda)
    dst = rng.choice(rows - 1, M, replace=False)
    dst[-5:] = rows - 1
    s = torch.arange(M, dtype=torch.int32, device=cuda)
    d = torch.as_tensor(dst.astype(np.int32), device=cuda)
    want = ref.page_copy_ref(src_pool, pool.clone(), s, d)
    got = ops.page_copy(src_pool, pool.clone(), s, d)
    torch.cuda.synchronize()
    assert torch.equal(got[:-1].view(torch.int32), want[:-1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("N,P", [(0, 1000), (100_000, 4096), (3, 1 << 20)])
def test_cuda_hot_bins_matches_plain(cuda, N, P):
    rng = np.random.default_rng(N + P)
    ids = torch.as_tensor(rng.integers(-2, P, N).astype(np.int32), device=cuda)
    cin = torch.as_tensor(rng.integers(0, 40, P).astype(np.int32), device=cuda)
    wc, wb = ref.hot_bins_ref(ids, cin, 6)
    gc, gb = ops.hot_bins(ids, cin, num_bins=6)
    torch.cuda.synchronize()
    assert torch.equal(gc, wc) and torch.equal(gb, wb)


# ------------------------------------------ page_move's one-pass schedule
# (mark, pass A, pass B) on every plan family, and hot_bins' cooperative kernel
MOVE_WIDTHS = [
    (torch.float32, 33), (torch.float32, 100), (torch.float32, 257), (torch.float32, 1024),
    (torch.bfloat16, 8192),  # a yi-6b KV page row (16 tokens x 4 heads x 128): 16 KiB
    (torch.float32, 512),  # its Quest summary row: 2 KiB
]


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _move_case(family, dtype, E, device, seed, rows=None):
    rows_f, src, dst, want = FAMILIES[family](np.random.default_rng(seed))
    rows = rows or rows_f
    pool = np.random.default_rng(seed + 1).normal(size=(rows, E)).astype(np.float32)
    ids = [torch.as_tensor(np.asarray(x, np.int64).astype(np.int32), device=device)
           for x in (src, dst)]
    return torch.as_tensor(pool).to(device, dtype), ids[0], ids[1], np.asarray(want)


def _gather(pool, s, d):
    """Gather semantics on the in-range entries (the kernel skips the rest)."""
    rows = pool.shape[0]
    keep = (s >= 0) & (s < rows) & (d >= 0) & (d < rows)
    return ref.page_move_ref(pool.clone(), s[keep], d[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype,E", MOVE_WIDTHS)
def test_cuda_page_move_plans(cuda, family, dtype, E):
    """Bit-equal to the gather on data-plane and KV plans, swaps, cycles,
    chains, trash, empty and out-of-range plans; the classes counted on the
    card are ``ref.page_move_classes``'."""
    pool, s, d, want = _move_case(family, dtype, E, cuda, E)
    expect = _gather(pool, s, d)
    got = ops.page_move(pool, s, d)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(expect))
    if len(want):
        classes = ref.page_move_classes(s, d, pool.shape[0]).cpu().numpy()
        assert np.array_equal(classes, want)
        counted = page_copy.page_move_classes(pool).tolist()
        assert counted == [int((want == c).sum()) for c in (A, B, S)]
    assert not page_copy._WORKSPACES[pool.device].marks.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,E", [(torch.float32, 33), (torch.bfloat16, 8192)])
def test_cuda_page_move_back_to_back(cuda, dtype, E):
    """Four different plans on one pool with no synchronisation between
    them: each call finds the marks its predecessor left clean."""
    pool, *_ = _move_case("kv", dtype, E, cuda, 3)  # the largest plan's rows
    want = pool.clone()
    for family, seed in (("dataplane", 3), ("swaps", 4), ("chains", 5), ("kv", 6),
                         ("dataplane", 7)):
        _, s, d, _ = _move_case(family, dtype, 1, cuda, seed)
        want = _gather(want, s, d)
        ops.page_move(pool, s, d)
    torch.cuda.synchronize()
    assert torch.equal(_bits(pool), _bits(want))
    assert not page_copy._WORKSPACES[pool.device].marks.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sorted_runs", "one_page", "pages_not_a_multiple_of_4",
                                  "no_ids", "out_of_range", "wrap", "unaligned"])
def test_cuda_hot_bins_cases(cuda, case):
    rng = np.random.default_rng(17)
    P = 1 << 16
    cin = rng.integers(0, 40, P)
    if case == "sorted_runs":  # the sampler's ids: runs of one page, sorted
        ids = np.repeat(np.arange(P), rng.poisson(3.0, P))
    elif case == "one_page":
        ids = np.full(200_000, 777)
    elif case == "pages_not_a_multiple_of_4":
        P = 1_000_003
        cin = rng.integers(0, 40, P)
        ids = np.sort(rng.integers(0, P, 300_000))
    elif case == "no_ids":
        P = 1_000_003
        cin = rng.integers(-3, 2**20, P)
        ids = np.zeros(0, np.int64)
    elif case == "out_of_range":
        ids = np.concatenate([rng.integers(-5, P + 5, 100_000),
                              [-(2**31), 2**31 - 1, P, P + 1, -1]])
    elif case == "wrap":  # counts past 2^31 wrap to negative and bin to 0
        cin = np.full(P, 2**31 - 3)
        ids = np.repeat(np.arange(0, P, 7), 5)
    else:  # counts_in a view one element into its storage: no 16-byte vectors
        ids = rng.integers(0, P, 50_000)
    ids_t = torch.as_tensor(ids.astype(np.int32), device=cuda)
    cin_t = torch.as_tensor(cin.astype(np.int32), device=cuda)
    if case == "unaligned":
        cin_t = torch.cat([cin_t[:1], cin_t])[1:]
    wc, wb = ref.hot_bins_ref(ids_t, cin_t, 6)
    gc, gb = ops.hot_bins(ids_t, cin_t, num_bins=6)
    torch.cuda.synchronize()
    assert torch.equal(gc, wc) and torch.equal(gb, wb)
    if case == "wrap":
        assert (gc < 0).any() and (gb[gc < 0] == 0).all()


# Tolerances of the reference's kernel tests (tests/test_kernels.py:21): the
# kernels accumulate in float32 in another order than the plain versions.
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _paged_inputs(rng, B, nh, nkv, dh, P, page, n_p, dtype, device):
    q = torch.as_tensor(rng.normal(size=(B, nh, dh)).astype(np.float32)).to(device, dtype)
    kp = torch.as_tensor(rng.normal(size=(P, page, nkv, dh)).astype(np.float32)).to(device, dtype)
    vp = torch.as_tensor(rng.normal(size=(P, page, nkv, dh)).astype(np.float32)).to(device, dtype)
    tables = np.full((B, n_p), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        used = rng.integers(1, n_p + 1)
        tables[b, :used] = rng.choice(P, used, replace=False)
        tables[b, rng.integers(0, used)] = -1 if used > 1 else tables[b, 0]  # a hole
        lens[b] = rng.integers(1, used * page + 1)
    lens[0] = 0  # a lane with no valid key returns 0
    return (q, kp, vp, torch.as_tensor(tables, device=device),
            torch.as_tensor(lens, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,nkv,dh,P,page,n_p", [
    (2, 4, 2, 64, 16, 8, 4),
    (3, 8, 1, 128, 32, 16, 6),
    (4, 16, 2, 128, 64, 32, 8),
    (32, 32, 4, 128, 4608, 16, 32),  # the serving slice's shape (yi-6b)
    (32, 16, 16, 128, 4608, 16, 32),  # qwen2-moe-a2.7b's: g = 1
    (4, 16, 16, 128, 96, 4, 2),  # the colocation legs' 4-token pages, Quest top-2
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain(cuda, B, nh, nkv, dh, P, page, n_p, dtype):
    rng = np.random.default_rng(B * 131 + P)
    args = _paged_inputs(rng, B, nh, nkv, dh, P, page, n_p, dtype, cuda)
    got = ops.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,nkv,Sq,Skv,dh,window,causal", [
    (2, 4, 2, 128, 128, 64, 0, True),
    (1, 8, 8, 96, 96, 128, 0, True),
    (2, 4, 1, 64, 192, 64, 0, True),  # Sq < Skv: suffix alignment
    (1, 2, 2, 300, 300, 64, 0, True),  # ragged tiles
    (1, 4, 2, 256, 256, 64, 64, True),  # sliding window
    (2, 4, 2, 40, 72, 16, 0, False),  # not causal, the smoke head width
    (1, 32, 4, 1024, 1024, 128, 0, True),  # the serving slice's prefill (yi-6b)
    (1, 16, 16, 1024, 1024, 128, 0, True),  # qwen2-moe-a2.7b's prefills: g = 1
    (1, 16, 16, 512, 512, 128, 0, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, B, nh, nkv, Sq, Skv, dh, window, causal,
                                            dtype):
    rng = np.random.default_rng(Sq + Skv + dh)
    q, k, v = (
        torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(cuda, dtype)
        for s in ((B, nh, Sq, dh), (B, nkv, Skv, dh), (B, nkv, Skv, dh))
    )
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# ------------------------------------------ the Hopper redesigns (bf16 wgmma
# flash attention, split-K paged attention)
def _flash_case(B, nh, nkv, Sq, Skv, dh, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(device, dtype)
        for s in ((B, nh, Sq, dh), (B, nkv, Skv, dh), (B, nkv, Skv, dh))
    )


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 63, 65, 129, 512, 1000])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_cuda_flash_attention_bf16_tiles(cuda, Sq, dh):
    """The wgmma kernel at ragged and whole q tiles, every head dim."""
    q, k, v = _flash_case(1, 8, 2, Sq, Sq, dh, torch.bfloat16, cuda, Sq * 3 + dh)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,nkv,Sq,Skv,window,causal", [
    (2, 8, 2, 100, 300, 0, True),  # Sq < Skv: suffix alignment, ragged
    (1, 8, 1, 64, 1024, 0, True),  # one q tile at the end of a long stream
    (1, 4, 2, 300, 300, 100, True),  # the window's edge cuts key tiles
    (2, 4, 4, 200, 200, 64, True),  # a window of exactly one tile
    (2, 8, 2, 130, 190, 0, False),  # not causal
    (1, 4, 2, 1, 500, 37, True),  # one query over a window
])
@pytest.mark.parametrize("dh", [16, 64, 128])
def test_cuda_flash_attention_bf16_masks(cuda, B, nh, nkv, Sq, Skv, window, causal, dh):
    q, k, v = _flash_case(B, nh, nkv, Sq, Skv, dh, torch.bfloat16, cuda, Sq + Skv + window)
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_p", [1, 5, 32, 33])
@pytest.mark.parametrize("page", [4, 8, 16, 32])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_splits(cuda, n_p, page, g, dtype):
    """The split-K kernel over table widths the split does and does not
    divide, every page size the pools use, MHA and yi-6b's GQA group."""
    B, nkv, dh = 6, 2, 128
    rng = np.random.default_rng(n_p * 100 + page + g)
    args = _paged_inputs(rng, B, nkv * g, nkv, dh, max(64, 2 * n_p), page, n_p, dtype, cuda)
    got = ops.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["lengths_zero", "tables_all_holes"])
def test_cuda_paged_attention_empty(cuda, dtype, case):
    """Every lane of length 0, or a table of all -1: exactly 0, no NaN."""
    rng = np.random.default_rng(7)
    q, kp, vp, tables, lens = _paged_inputs(rng, 32, 32, 4, 128, 256, 16, 32, dtype, cuda)
    if case == "lengths_zero":
        lens = torch.zeros_like(lens)
    else:
        tables = torch.full_like(tables, -1)
    got = ops.paged_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


# ------------------------------------------ the MoE slice: expert swaps, moe_mlp
@pytest.mark.cuda
@pytest.mark.parametrize("row_elems", [2048 * 1408, 512 * 1024])  # 5.5 MiB and 1 MiB bf16
def test_cuda_page_move_expert_swaps(cuda, row_elems):
    """An expert migration's plan: 8 paired swaps (src = [a, b], dst = [b, a]).
    Every entry reads a row the plan writes, so all are staged (class S);
    the result is the gather, twice back to back, and the marks end zero."""
    rows = 40
    g = torch.Generator(device=cuda)
    g.manual_seed(row_elems)
    pool = torch.randn((rows, row_elems), generator=g, device=cuda).to(torch.bfloat16)
    want = pool.clone()
    rng = np.random.default_rng(row_elems)
    for _ in range(2):
        fast, slow = rng.choice(10, 8, replace=False), 10 + rng.choice(rows - 10, 8, replace=False)
        src = np.stack([slow, fast], 1).reshape(-1)
        dst = np.stack([fast, slow], 1).reshape(-1)
        s, d = (torch.as_tensor(x.astype(np.int32), device=cuda) for x in (src, dst))
        want = ref.page_move_ref(want, s, d)
        ops.page_move(pool, s, d)
        assert page_copy.page_move_classes(pool).tolist() == [0, 0, 16]
        assert bool((ref.page_move_classes(s, d, rows) == S).all())
    torch.cuda.synchronize()
    assert torch.equal(_bits(pool), _bits(want))
    assert not page_copy._WORKSPACES[pool.device].marks.any()


@pytest.mark.cuda
@pytest.mark.parametrize("width,tokens", [("smoke", 40), ("full", 32)])
def test_cuda_moe_mlp_matches_cpu(cuda, width, tokens):
    """``moe_mlp`` on the card and on the CPU on the same float32 inputs and
    weights (full float32 products, no TF32): equal gate ids, ranks and
    drops, outputs within 1e-4. ``full`` is qwen2-moe-a2.7b's width with one
    layer's weights, at the decode batch of 32 (capacity 8)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen2-moe-a2.7b")
    cfg = cfg.smoke() if width == "smoke" else dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(5)
    params = moe.init_moe(gen, cfg, "cpu")
    rng = np.random.default_rng(tokens)
    base = rng.normal(size=(1, 1, cfg.d_model))
    x = (base + rng.normal(size=(1, tokens, cfg.d_model))).astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = {k: (v.to(cuda) if not isinstance(v, dict) else {kk: vv.to(cuda)
                                                               for kk, vv in v.items()})
               for k, v in params.items()}
        xc, xg = torch.as_tensor(x), torch.as_tensor(x).to(cuda)
        cap = moe.capacity(tokens, cfg)
        rc = moe.route(params["router"], xc.reshape(tokens, -1), cfg, cap)
        rg = moe.route(gpu["router"], xg.reshape(tokens, -1), cfg, cap)
        oc, ac = moe.moe_mlp(params, xc, cfg)
        og, ag = moe.moe_mlp(gpu, xg, cfg)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(rg.gate_ids.cpu(), rc.gate_ids)
    assert torch.equal(rg.rank.cpu(), rc.rank) and torch.equal(rg.valid.cpu(), rc.valid)
    torch.testing.assert_close(og.cpu(), oc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ag.cpu(), ac, atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "sampled"])
@pytest.mark.parametrize("queue", [0, 64], ids=["instant", "queue"])
def test_cuda_fleet_matches_machines_alone(cuda, exact, queue):
    """A fleet of three machines with different knobs on the card equals
    the same machines run alone on the card, bit for bit, with no vmap
    batching-rule fallback."""
    import warnings

    from repro_torch.core.fleet import FleetManager
    from repro_torch.core.manager import CentralManager
    from repro_torch.core.types import state_to_numpy

    P, E = 4096, 5

    def machine(s):
        kw = dict(num_pages=P, fast_capacity=1024 + 128 * s, migration_budget=64 + 32 * s,
                  max_tenants=8, sample_period=(1, 100, 400)[s], seed=s,
                  ewma_lambda=(0.5, 0.3, 0.7)[s], fair_mode=bool(s % 2), num_bins=5 + s,
                  exact_sampling=exact, queue_size=queue, device=cuda)
        if queue:
            kw.update(migration_bandwidth=16 + 16 * s, migration_latency=s % 2)
        m = CentralManager(**kw)
        for t_miss, n in ((0.1, 1200), (0.5, 1200), (1.0, 800)):
            m.allocate(m.register(t_miss), n)
        return m

    counts = (np.random.default_rng(9).poisson(4, (3, E, P)) * 9).astype(np.int64)
    fleet = FleetManager([machine(s) for s in range(3)])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        res = fleet.run_epochs(E, counts=counts, collect_plans=True)
    for s in range(3):
        alone = machine(s)
        want = alone.run_epochs(E, counts=counts[s], collect_plans=True)
        got = res.machine(s)
        for f in ("fmmr_now", "fmmr_ewma", "fast_pages", "promoted", "demoted", "sentinel"):
            a, b = getattr(got.stats, f).cpu(), getattr(want.stats, f).cpu()
            assert torch.equal(a, b.to(a.dtype)), (s, f)
        n = want.plans.promote.shape[-1]
        assert torch.equal(got.plans.promote[..., :n], want.plans.promote.cpu()), s
        assert torch.equal(got.plans.demote[..., :n], want.plans.demote.cpu()), s
        fs, ws = state_to_numpy(fleet.machines[s]._state), state_to_numpy(alone._state)
        for part in ("pages", "tenants"):
            for a, b in zip(getattr(fs, part), getattr(ws, part)):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (s, part)
        assert fleet.machines[s].queue_counters() == alone.queue_counters()


@pytest.mark.cuda
def test_cuda_autotuner_matches_cpu(cuda, monkeypatch):
    """The exact tiny search (skewshift, 1,024 pages x 12 epochs, fast 128,
    population 4, generations 2, seed 7, sample_period pinned to 1, 4 KiB
    pages, 40 us epochs) on the card equals the same search on the CPU:
    trajectory and winner, floats exact; then an online burst on the card
    leaves the live manager's state and generator as they were."""
    import dataclasses

    from repro_torch.core.manager import CentralManager
    from repro_torch.core.simulator import OPTANE, ColocationSim
    from repro_torch.core.types import state_to_numpy
    from repro_torch.launch import hillclimb as th

    space = dict(th.SEARCH_SPACE)
    space["sample_period"] = dict(kind="int", lo=1, hi=1, log=True, default=1)
    monkeypatch.setattr(th, "SEARCH_SPACE", space)
    orig = th.run_sweep
    monkeypatch.setattr(th, "run_sweep", lambda sweep, **kw: orig(
        sweep, machine=dataclasses.replace(OPTANE, page_bytes=4096), epoch_seconds=4e-5, **kw))
    geom = th.TunerGeometry(n_pages=1024, n_epochs=12, fast=128, policy_chunk=4)
    runs = {dev: th.PolicyAutotuner("skewshift", geom, population=4, generations=2, seed=7,
                                    device=dev).search() for dev in (cuda, "cpu")}
    gpu, cpu = runs[cuda], runs["cpu"]
    assert gpu.trajectory == cpu.trajectory
    assert gpu.winner == cpu.winner and gpu.ref == cpu.ref

    mgr = CentralManager(num_pages=512, fast_capacity=64, migration_budget=32, max_tenants=8,
                         queue_size=32, device=cuda)
    mgr.params = mgr.params._replace(migration_budget=8)
    sim = ColocationSim(mgr, OPTANE, seed=4, policy_chunk=2)
    sim.run_scenario(th.skewshift_scenario(512, 4, shift_epoch=2))
    mgr._ensure_segs()
    before = state_to_numpy(mgr._state)
    gen_before = mgr._state.rng.get_state().clone()
    tuner = th.OnlineTuner(sim, seed=1, device=cuda)
    tuner._burst(tuner._candidate_params(np.random.default_rng(0)), np.random.default_rng(1))
    after = state_to_numpy(mgr._state)
    for part in ("pages", "tenants", "queue", "segs"):
        for f, a in getattr(before, part)._asdict().items():
            assert np.array_equal(a, getattr(getattr(after, part), f)), (part, f)
    assert torch.equal(mgr._state.rng.get_state(), gen_before)


@pytest.mark.cuda
def test_cuda_train_steps_match_cpu(cuda):
    """Six smoke train steps (qwen2.5-3b, float32, no TF32) from one state
    copied tensor by tensor to the card: losses within 1e-4 relative,
    parameters within 2e-4 (a fifth of one Adam step at lr 1e-3: an element
    whose gradient is near zero may take a step of another size), the step
    counters equal. The training path launches none of the five kernels."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_state import init_train_state, make_train_step, state_to

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("qwen2.5-3b").smoke()
    cpu = init_train_state(cfg, 0, device="cpu")
    gpu = state_to(cpu, cuda)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2), microbatch=2)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=17))
    ops.reset_launch_counts()
    for s in range(6):
        b = {k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}
        cpu, mc = step(cpu, b)
        gpu, mg = step(gpu, {k: v.to(cuda) for k, v in b.items()})
        assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-4)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    assert int(gpu.opt.step) == int(cpu.opt.step) == 6
    for (path, c), (_, g) in zip(named_leaves(cpu.params), named_leaves(gpu.params)):
        torch.testing.assert_close(g.cpu(), c, atol=2e-4, rtol=0, msg=str(path))


# ------------------------------------------ the SSM, hybrid and encoder-decoder
# families: flash_attention at their prefill shapes, and each family's smoke
# train steps and decode on the card against the CPU
@pytest.mark.cuda
@pytest.mark.parametrize("B,nh,Sq,Skv,window,causal", [
    (8, 32, 4608, 4608, 4096, True),  # zamba2-1.2b's prefill: the window, g = 1
    (8, 32, 4616, 4616, 4096, True),  # its teacher-forced context: a ragged q tile
    (32, 6, 1500, 1500, 0, False),  # whisper-tiny's encoder
    (32, 6, 448, 1500, 0, False),  # whisper-tiny's cross-attention at its decoder length
    (32, 6, 9, 9, 0, True),  # its teacher-forced decoder's self-attention
    (32, 6, 9, 1500, 0, False),  # and cross-attention
])
def test_cuda_flash_attention_family_shapes(cuda, B, nh, Sq, Skv, window, causal):
    """bf16 at full width, every lane against its own plain call (the whole
    call's float32 scores would not fit the card at 4,608): each lane's
    output reads only its own inputs."""
    q, k, v = _flash_case(B, nh, nh, Sq, Skv, 64, torch.bfloat16, cuda, Sq + Skv + window)
    got = ops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    tol = ATTN_TOL[torch.bfloat16]
    for b in range(B):
        want = ref.flash_attention_ref(q[b : b + 1], k[b : b + 1], v[b : b + 1], causal=causal,
                                       sliding_window=window)
        torch.testing.assert_close(got[b : b + 1].float(), want.float(), atol=tol, rtol=tol,
                                   msg=f"lane {b}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b", "whisper-tiny"])
def test_cuda_family_matches_cpu(cuda, arch):
    """Each family's smoke config at its published SSD chunk (128, 256; rows
    of 256 tokens reach it), float32, no TF32: four train steps from one
    state on the card and the CPU (losses within 1e-4 relative, parameters
    within 2e-4, every loss and gradient norm finite), then a prefill and 8
    decode steps with the CPU's trained weights on both (logits within 1e-4
    of the largest, the CPU's tokens fed to both). The train step launches no
    kernel; the prefills launch ``flash_attention`` where the family has
    attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import encdec, hybrid, ssm_lm
    from repro_torch.training.optimizer import AdamWConfig, named_leaves, tree_map
    from repro_torch.training.train_state import init_train_state, make_train_step, state_to

    assert not torch.backends.cuda.matmul.allow_tf32
    full = get_config(arch)
    cfg = dataclasses.replace(full.smoke(), ssm_chunk=full.ssm_chunk)
    cpu = init_train_state(cfg, 0, device="cpu")
    gpu = state_to(cpu, cuda)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 256, 2, seed=17))
    frames = (torch.randn((2, cfg.max_encoder_len, cfg.d_model),
                          generator=torch.Generator().manual_seed(3))
              if cfg.is_encoder_decoder else None)
    ops.reset_launch_counts()
    for s in range(4):
        b = {k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}
        if frames is not None:
            b["enc_embeds"] = frames
        cpu, mc = step(cpu, b)
        gpu, mg = step(gpu, {k: v.to(cuda) for k, v in b.items()})
        assert float(mg["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-4)
        for m in (mc, mg):
            assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    for (path, c), (_, g) in zip(named_leaves(cpu.params), named_leaves(gpu.params)):
        torch.testing.assert_close(g.cpu(), c, atol=2e-4, rtol=0, msg=str(path))

    # the decode paths on the same weights: the CPU's trained ones
    mod = {"mamba2-130m": ssm_lm, "zamba2-1.2b": hybrid, "whisper-tiny": encdec}[arch]
    prompt = torch.as_tensor(data.batch_at(9)["tokens"][:, :40])
    params = {"cpu": cpu.params, "gpu": tree_map(lambda t: t.to(cuda), cpu.params)}
    out = {}
    for dev, p in params.items():
        where = p["embed"].device
        if frames is not None:
            out[dev] = mod.prefill(p, frames.to(where), prompt.to(where), cfg, 48)
        else:
            out[dev] = mod.prefill(p, prompt.to(where), cfg, 48)
    (lc, cc), (lg, cg) = out["cpu"], out["gpu"]
    for i in range(9):
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4 * float(lc.abs().max()), rtol=0)
        if i == 8:
            break
        tok = torch.argmax(lc, dim=-1)
        lc, cc = mod.decode_step(params["cpu"], tok, cc, cfg)
        lg, cg = mod.decode_step(params["gpu"], tok.to(cuda), cg, cfg)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["flash_attention"] > 0) == (arch != "mamba2-130m")
