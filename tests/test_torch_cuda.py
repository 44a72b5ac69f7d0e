"""The port's CUDA kernels on the card: each hand-written kernel against its
plain PyTorch version, bit for bit. Every test here needs a CUDA device and
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
