"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's entry points (``repro_torch.kernels.ops``) run the
plain PyTorch versions; the Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them. Inputs are made with numpy from a seed.
Tolerance: bit-equal (row copies and integer histograms are exact).

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hot_bins as jhot
from repro.kernels import page_copy as jpc
from repro_torch.kernels import ops


def _bits(x):
    """Raw bits of a torch or JAX array as a numpy integer array."""
    a = x.detach().cpu() if isinstance(x, torch.Tensor) else x
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.uint8) if a.dtype.is_floating_point else a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.uint8) if a.dtype.kind == "f" else a


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor."""
    if dtype == "bfloat16":
        return jnp.asarray(arr, jnp.bfloat16), torch.as_tensor(arr).to(torch.bfloat16)
    return jnp.asarray(arr.astype(dtype)), torch.as_tensor(arr.astype(dtype))


def _ids(a):
    return jnp.asarray(a, jnp.int32), torch.as_tensor(np.asarray(a, np.int32))


# ---------------------------------------------------------------- page_move
@pytest.mark.parametrize("Pr,E,M", [(16, 64, 3), (11, 100, 4), (9, 257, 5), (5, 33, 3)])
def test_page_move_matches_pallas(Pr, E, M):
    rng = np.random.default_rng(Pr * 7 + E)
    pool_np = rng.normal(size=(Pr, E)).astype(np.float32)
    sid = rng.choice(Pr - 1, M, replace=False)
    did = rng.permutation(Pr - 1)[:M]
    want = jpc.page_move(jnp.asarray(pool_np), *(_ids(sid)[0], _ids(did)[0]))
    got = ops.page_move(torch.as_tensor(pool_np.copy()), _ids(sid)[1], _ids(did)[1])
    assert np.array_equal(_bits(got), _bits(want))


def test_page_move_write_after_read():
    """A plan may write a row that an earlier entry read (demote vacates a
    fast frame, a promote of the same sweep fills it)."""
    pool_np = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    sid, did = [1, 5], [6, 1]
    want = jpc.page_move(jnp.asarray(pool_np), _ids(sid)[0], _ids(did)[0])
    got = ops.page_move(torch.as_tensor(pool_np.copy()), _ids(sid)[1], _ids(did)[1])
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(got[6].numpy(), pool_np[1])
    assert np.array_equal(got[1].numpy(), pool_np[5])


def test_page_move_trash_padding_leaves_real_rows():
    rng = np.random.default_rng(1)
    pool_np = rng.normal(size=(8, 48)).astype(np.float32)
    trash = 7
    sid, did = [0, trash, trash, trash], [3, trash, trash, trash]
    want = np.asarray(jpc.page_move(jnp.asarray(pool_np), _ids(sid)[0], _ids(did)[0]))
    got = ops.page_move(torch.as_tensor(pool_np.copy()), _ids(sid)[1], _ids(did)[1]).numpy()
    assert np.array_equal(got, want)
    keep = [0, 1, 2, 4, 5, 6, trash]
    assert np.array_equal(got[keep], pool_np[keep])


# ---------------------------------------------------------------- page_copy
@pytest.mark.parametrize("Ps,Pd,E,M", [
    (16, 16, 128, 5), (8, 32, 256, 8), (4, 4, 64, 1),
    (7, 13, 100, 3), (5, 9, 257, 7), (3, 3, 33, 2), (17, 31, 384, 17),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_page_copy_matches_pallas(Ps, Pd, E, M, dtype):
    rng = np.random.default_rng(Ps * 101 + E + M)
    if dtype == "int32":
        src_np = rng.integers(0, 100, (Ps, E))
        dst_np = rng.integers(0, 100, (Pd, E))
    else:
        src_np = rng.normal(size=(Ps, E)).astype(np.float32)
        dst_np = rng.normal(size=(Pd, E)).astype(np.float32)
    sid = rng.choice(Ps, M, replace=True)
    did = rng.choice(Pd, M, replace=False)
    js, ts = _pair(src_np, dtype)
    jd, td = _pair(dst_np, dtype)
    want = jpc.page_copy(js, jd, _ids(sid)[0], _ids(did)[0])
    got = ops.page_copy(ts, td, _ids(sid)[1], _ids(did)[1])
    assert np.array_equal(_bits(got), _bits(want))


def test_page_copy_trash_row_isolation():
    """Padded entries all aim at the trash row: every real row matches the
    reference; the trash row's content is unspecified and not compared."""
    rng = np.random.default_rng(0)
    src_np = rng.normal(size=(6, 64)).astype(np.float32)
    dst_np = rng.normal(size=(10, 64)).astype(np.float32)
    trash = 9
    sid, did = [2, 5, 0, 3, 1], [1, 4, trash, trash, trash]
    want = np.asarray(jpc.page_copy(jnp.asarray(src_np), jnp.asarray(dst_np),
                                    _ids(sid)[0], _ids(did)[0]))
    got = ops.page_copy(torch.as_tensor(src_np), torch.as_tensor(dst_np.copy()),
                        _ids(sid)[1], _ids(did)[1]).numpy()
    assert np.array_equal(got[:trash], want[:trash])
    assert np.array_equal(got[1], src_np[2]) and np.array_equal(got[4], src_np[5])
    keep = [0, 2, 3, 5, 6, 7, 8]
    assert np.array_equal(got[keep], dst_np[keep])


# ----------------------------------------------------------------- hot_bins
@pytest.mark.parametrize("N,P,tile", [
    (100, 64, 64), (1000, 512, 128), (257, 130, 64), (64, 4096, 512),
    (333, 130, 64), (1023, 777, 256), (65, 513, 512),
])
def test_hot_bins_matches_pallas(N, P, tile):
    rng = np.random.default_rng(N + P)
    ids = rng.integers(-3, P, N).astype(np.int32)  # negative ids are ignored
    cin = rng.integers(0, 40, P).astype(np.int32)
    jc, jb = jhot.hot_bins(jnp.asarray(ids), jnp.asarray(cin), tile=tile, n_chunk=128)
    tc, tb = ops.hot_bins(torch.as_tensor(ids), torch.as_tensor(cin), num_bins=6)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("num_bins", [2, 6, 12])
def test_hot_bins_counts_near_powers_of_two(num_bins):
    """Counts land on 2^k - 1, 2^k and 2^k + 1 after accumulation, where
    floor(log2) changes."""
    ks = np.arange(0, 30)
    targets = np.concatenate([2**ks - 1, 2**ks, 2**ks + 1]).astype(np.int64)
    P = targets.shape[0]
    cin = (targets - 2).clip(0).astype(np.int32)
    hits = (targets - cin).astype(np.int64)  # 0..2 hits per page
    ids = np.repeat(np.arange(P), hits).astype(np.int32)
    ids = np.concatenate([ids, np.full(17, -1, np.int32)])
    jc, jb = jhot.hot_bins(jnp.asarray(ids), jnp.asarray(cin), num_bins=num_bins,
                           tile=128, n_chunk=64)
    tc, tb = ops.hot_bins(torch.as_tensor(ids), torch.as_tensor(cin), num_bins=num_bins)
    assert np.array_equal(tc.numpy(), targets.astype(np.int32))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tb.numpy(), np.asarray(jb))


def test_hot_bins_no_ids_bins_the_counts():
    cin = np.array([0, 1, 2, 3, 4, 31, 32, 33, 2**31 - 1], np.int32)
    # the Pallas kernel takes no empty id vector: ids of -1 add nothing
    jc, jb = jhot.hot_bins(jnp.full(64, -1, jnp.int32), jnp.asarray(cin), tile=64, n_chunk=64)
    tc, tb = ops.hot_bins(torch.zeros(0, dtype=torch.int32), torch.as_tensor(cin))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
