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

from repro_torch.kernels import ops, ref


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
@pytest.mark.parametrize("page", [8, 16, 32])
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
