"""Page-move plans for the port's tests, built with numpy from a seed (no
JAX here: ``tests/test_torch_cuda.py`` imports this module on the card).

Each plan function takes a ``numpy.random.Generator`` and returns
``(rows, src, dst, classes)``: the pool's row count, the plan's ids and the
class each entry must take in the CUDA ``page_move``'s schedule
(``ref.page_move_classes``)."""
import numpy as np

from repro_torch.kernels import ref

NONE, A, B, S = ref.MOVE_NONE, ref.MOVE_A, ref.MOVE_B, ref.MOVE_S


def _dataplane(rng):
    """PagePool.execute's plan: demotes move fast frames to free slow frames,
    promotes fill the vacated fast frames; trash->trash padding."""
    fast, slow, pairs, M = 64, 192, 24, 80
    rows = fast + slow + 1
    trash = rows - 1
    f = rng.choice(fast, pairs, replace=False)
    sl = fast + rng.choice(slow, 2 * pairs, replace=False)
    src, dst = np.full(M, trash), np.full(M, trash)
    src[:pairs], dst[:pairs] = f, sl[:pairs]
    src[pairs : 2 * pairs], dst[pairs : 2 * pairs] = sl[pairs:], f[::-1]
    want = np.full(M, NONE)
    want[:pairs], want[pairs : 2 * pairs] = A, B
    return rows, src, dst, want


def _kv(rng):
    """TieredPagedKV.migrate's plan: demotes to free slow slots, then
    promotes into free fast slots, the vacated ones first (a stack), the
    slot moves expanded over layers (row = layer * n_slots + slot)."""
    L, n_fast, n_slots = 3, 16, 96
    owned_slow = n_fast + rng.choice(n_slots - n_fast, 40, replace=False)
    free_slow = [int(s) for s in range(n_fast, n_slots) if s not in set(owned_slow)]
    free_fast = [int(s) for s in rng.choice(n_fast, 3, replace=False)]
    demote = [int(s) for s in rng.choice(sorted(set(range(n_fast)) - set(free_fast)), 5,
                                         replace=False)]
    moves, kinds = [], []
    for s in demote:
        moves.append((s, free_slow.pop()))
        kinds.append(A)
        free_fast.append(s)
    for s in owned_slow[:7]:
        d = free_fast.pop()
        moves.append((int(s), d))
        kinds.append(B if d in demote else A)
    base = np.arange(L)[:, None] * n_slots
    src = (base + np.array([m[0] for m in moves])[None]).reshape(-1)
    dst = (base + np.array([m[1] for m in moves])[None]).reshape(-1)
    return L * n_slots, src, dst, np.tile(np.array(kinds), L)


def _swaps(rng):
    rows = 40
    ab = rng.choice(rows, 12, replace=False).reshape(6, 2)
    src = np.concatenate([ab[:, 0], ab[:, 1]])
    dst = np.concatenate([ab[:, 1], ab[:, 0]])
    return rows, src, dst, np.full(12, S)


def _cycles3(rng):
    rows = 50
    c = rng.choice(rows, 15, replace=False).reshape(5, 3)
    src = c.reshape(-1)
    dst = np.roll(c, -1, axis=1).reshape(-1)
    return rows, src, dst, np.full(15, S)


def _chains(rng):
    """Chains of 3, 4 and 5 links a0 -> a1 -> ... listed in a shuffled
    order: the first link is B, the inner links S, the last A."""
    rows = 64
    ids = rng.choice(rows, 3 + 1 + 4 + 1 + 5 + 1, replace=False)
    src, dst, want, lo = [], [], [], 0
    for k in (3, 4, 5):
        a = ids[lo : lo + k + 1]
        lo += k + 1
        src += list(a[:-1])
        dst += list(a[1:])
        want += [B] + [S] * (k - 2) + [A]
    order = rng.permutation(len(src))
    return rows, np.array(src)[order], np.array(dst)[order], np.array(want)[order]


def _all_trash(rng):
    rows = 20
    return rows, np.full(16, rows - 1), np.full(16, rows - 1), np.full(16, NONE)


def _empty(rng):
    return 10, np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)


def _out_of_range(rng):
    """Data-plane pairs with entries whose ids leave the pool: skipped."""
    rows, src, dst, want = _dataplane(rng)
    bad = np.array([-1, rows, rows + 5, -3, 2**31 - 1])
    src, dst, want = list(src), list(dst), list(want)
    for i, b in enumerate(bad):
        src.insert(3 * i, b if i % 2 else 1)
        dst.insert(3 * i, 2 if i % 2 else b)
        want.insert(3 * i, NONE)
    return rows, np.array(src), np.array(dst), np.array(want)


def _mixed(rng):
    """Pairs, a swap, a chain and a self-copy in one plan."""
    rows = 30
    p = rng.permutation(rows)
    src = [p[0], p[1], p[3], p[4], p[5], p[6], p[8], p[9]]
    dst = [p[1], p[2], p[4], p[3], p[6], p[7], p[8], p[10]]
    want = [B, A, S, S, B, A, NONE, A]
    return rows, np.array(src), np.array(dst), np.array(want)


FAMILIES = {
    "dataplane": _dataplane, "kv": _kv, "swaps": _swaps, "cycles3": _cycles3,
    "chains": _chains, "all_trash": _all_trash, "empty": _empty,
    "out_of_range": _out_of_range, "mixed": _mixed,
}
