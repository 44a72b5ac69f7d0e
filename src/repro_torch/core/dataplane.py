"""Pool-backed page data plane: page contents in one device pool.

Rows ``[0, F)`` of the pool are fast-tier frames, ``[F, F + P)`` slow
frames, and the last row is the reserved trash row that pads fixed-size
plans. A host-side numpy frame table maps page id -> frame; allocate/free
are host bookkeeping, and every data movement goes through the kernels of
``repro_torch.kernels.ops``:

  * migrations  — one ``page_move`` call per ``plan_slots`` drained pages:
    demote entries first (their vacated fast frames are legally reused as
    promote destinations: the kernel reads every source before it writes
    any destination), then promotes, padded with trash-row self-copies;
  * bulk writes — tenant data is staged and copied into frames with
    ``page_copy`` (staging pool -> page pool), trash-padded likewise.

The pool tensor is updated in place (the reference donates it).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import TIER_FAST
from repro_torch.kernels import ops


class PagePool:
    def __init__(
        self,
        num_pages: int,
        fast_capacity: int,
        row_elems: int = 128,
        dtype=torch.float32,
        plan_slots: int = 64,
        *,
        device,
    ):
        self.num_pages = num_pages
        self.fast_capacity = fast_capacity
        self.row_elems = row_elems
        self.plan_slots = plan_slots
        self.device = torch.device(device)
        self.trash = fast_capacity + num_pages  # reserved last row
        self.pool = torch.zeros((self.trash + 1, row_elems), dtype=dtype, device=self.device)
        self.frame = np.full(num_pages, -1, np.int64)  # page -> frame row
        # LIFO free lists; fast frames are scarce, slow frames can hold all
        self._free_fast = list(range(fast_capacity - 1, -1, -1))
        self._free_slow = list(range(self.trash - 1, fast_capacity - 1, -1))
        self.moved_pages = 0  # cumulative pages moved by migrations
        self.move_seconds = 0.0  # host time inside page_move calls
        self.fault_injector = None
        self.last_failed = (np.empty(0, np.int64), np.empty(0, np.int64))

    def set_fault_injector(self, injector) -> None:
        """Attach (or with ``None`` detach) a ``FaultInjector``."""
        self.fault_injector = injector

    # ------------------------------------------------------------ control
    def on_allocate(self, page_ids: Sequence[int], tiers: Sequence[int]) -> None:
        """Assign a frame (in the page's tier) to each newly allocated page."""
        for p, t in zip(np.asarray(page_ids), np.asarray(tiers)):
            free = self._free_fast if t == TIER_FAST else self._free_slow
            self.frame[p] = free.pop()

    def on_free(self, page_ids: Sequence[int]) -> None:
        for p in np.asarray(page_ids):
            f = int(self.frame[p])
            if f < 0:
                continue
            (self._free_fast if f < self.fast_capacity else self._free_slow).append(f)
            self.frame[p] = -1

    # --------------------------------------------------------------- data
    def _ids(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def write_pages(self, page_ids: Sequence[int], rows) -> None:
        """Copy tenant data into page frames (staging -> pool, page_copy).
        ``rows`` is a numpy array or a tensor of [len(page_ids), row_elems]."""
        ids = np.asarray(page_ids, np.int64)
        rows = torch.as_tensor(rows).to(device=self.device, dtype=self.pool.dtype)
        M = self.plan_slots
        src = self._ids(np.arange(M))
        for lo in range(0, len(ids), M):
            chunk = ids[lo : lo + M]
            n = len(chunk)
            if n == M:
                staging = rows[lo : lo + M].contiguous()
            else:
                staging = self.pool.new_zeros((M, self.row_elems))
                staging[:n] = rows[lo : lo + n]
            dst = np.full(M, self.trash, np.int64)
            dst[:n] = self.frame[chunk]
            ops.page_copy(staging, self.pool, src, self._ids(dst))

    def read_page(self, page_id: int) -> np.ndarray:
        f = int(self.frame[page_id])
        assert f >= 0, f"page {page_id} has no frame"
        return self.pool[f].cpu().numpy()

    def read_pages(self, page_ids: Sequence[int]) -> torch.Tensor:
        """Rows of several pages, as a tensor on the pool's device."""
        frames = self.frame[np.asarray(page_ids, np.int64)]
        if (frames < 0).any():
            raise ValueError("read_pages: a page without a frame")
        return self.pool[torch.as_tensor(frames, device=self.device)]

    # ---------------------------------------------------------- migration
    def execute(self, demote_ids, promote_ids) -> int:
        """Move drained pages across tiers; returns pages moved.

        ``demote_ids``/``promote_ids`` are -1-padded id lists. Demotes are
        planned first so their vacated fast frames can serve as promote
        destinations within the same ``page_move`` call (write-after-read,
        which the kernel's gather-then-scatter makes safe).
        """
        dem = np.asarray(demote_ids).ravel()
        pro = np.asarray(promote_ids).ravel()
        dem = dem[dem >= 0]
        pro = pro[pro >= 0]
        fi = self.fault_injector
        failed_dem, failed_pro = [], []
        src, dst = [], []
        for p in dem:
            if fi is not None and int(self.frame[p]) >= self.fast_capacity:
                continue  # already physically slow: an earlier promote failed
            if fi is not None and not fi.attempt_move():
                failed_dem.append(int(p))
                continue
            f = int(self.frame[p])
            src.append(f)
            dst.append(self._free_slow.pop())
            self.frame[p] = dst[-1]
            self._free_fast.append(f)  # reusable by this batch's promotes
        freed_slow = []
        for p in pro:
            if fi is not None:
                if int(self.frame[p]) < self.fast_capacity:
                    continue  # already physically fast: a demote failed
                if not self._free_fast:
                    fi.no_frame += 1
                    failed_pro.append(int(p))
                    continue
                if not fi.attempt_move():
                    failed_pro.append(int(p))
                    continue
            f = int(self.frame[p])
            src.append(f)
            dst.append(self._free_fast.pop())
            self.frame[p] = dst[-1]
            freed_slow.append(f)  # released only after the sweep
        self.last_failed = (np.asarray(failed_dem, np.int64), np.asarray(failed_pro, np.int64))
        n = len(src)
        M = self.plan_slots
        for lo in range(0, n, M):
            s = np.full(M, self.trash, np.int64)
            d = np.full(M, self.trash, np.int64)
            s[: len(src[lo : lo + M])] = src[lo : lo + M]
            d[: len(dst[lo : lo + M])] = dst[lo : lo + M]
            s_t, d_t = self._ids(s), self._ids(d)
            t0 = time.perf_counter()
            ops.page_move(self.pool, s_t, d_t)
            self.move_seconds += time.perf_counter() - t0
        self._free_slow.extend(freed_slow)
        self.moved_pages += n
        return n

    # ------------------------------------------------------------- checks
    def check(self, tier: Optional[np.ndarray] = None) -> None:
        """Frame-table invariants: frames are a bijection onto used rows,
        fast frames exactly back fast-tier pages, free lists disjoint."""
        used = self.frame[self.frame >= 0]
        assert len(np.unique(used)) == len(used), "frame table not injective"
        assert self.trash not in used, "trash row assigned to a page"
        free = np.asarray(self._free_fast + self._free_slow, np.int64)
        assert not np.intersect1d(free, used).size, "free list overlaps used"
        assert len(np.unique(free)) == len(free), "duplicate free frames"
        assert len(free) + len(used) == self.trash, "frames leaked"
        if tier is not None:
            fast_pages = np.flatnonzero(np.asarray(tier) == TIER_FAST)
            backed = self.frame[fast_pages]
            assert (backed >= 0).all(), "fast page without a frame"
            assert (backed < self.fast_capacity).all(), "fast page on slow frame"
