"""Tiered paged KV cache on PyTorch.

A *logical page* (what MaxMem tracks and migrates) is a block of
``page_tokens`` consecutive tokens of one sequence, spanning all layers and
both K and V. Physically, pools are [L, n_slots, page, nkv, dh] for K and
V, on one device. Slots [0, n_fast) are the fast tier, [n_fast, n_slots)
the slow tier. ``slot_of`` maps logical page id -> physical slot; migration
copies slot contents across the boundary (the ``page_move`` kernel on the
card) and rewrites the mapping, so block tables hold logical ids and never
change. Quest summaries (per-page key max/min, float32) ride along for the
decode step's top-k page selection.

Free/reuse invariant, as in the reference: the slot of an unallocated
logical page always holds zero K/V and reset (±inf) summaries.
``free_pages`` scrubs the slots of a finished sequence, and ``migrate``
re-scrubs the vacated source rows that its swaps hand to free holders
(``page_move`` has gather semantics, so such a row keeps a stale copy).

The pools are updated in place (the reference rebinds new arrays).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.manager import CentralManager, resolve_device
from repro_torch.core.types import MigrationPlan
from repro_torch.kernels import ops


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, np.int64).ravel()


class TieredPagedKV:
    def __init__(self, cfg, n_fast_slots: int, n_slow_slots: int, page_tokens: int = 16,
                 dtype: torch.dtype = torch.float32, device=None):
        """Pools on ``device`` (``None`` = the card, which raises where there
        is none)."""
        self.cfg = cfg
        self.device = resolve_device(device, what="TieredPagedKV")
        self.page = page_tokens
        self.n_fast = n_fast_slots
        self.n_slots = n_fast_slots + n_slow_slots
        L, nkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.d_head
        shape = (L, self.n_slots, page_tokens, nkv, dh)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_max = torch.full((L, self.n_slots, nkv, dh), -torch.inf, device=self.device)
        self.k_min = torch.full((L, self.n_slots, nkv, dh), torch.inf, device=self.device)
        # logical page id -> physical slot. Identity at boot: the manager
        # hands out page ids with tier semantics (id < n_fast iff fast).
        self.slot_of = np.arange(self.n_slots, dtype=np.int32)

    def page_bytes(self) -> int:
        L, nkv, dh = self.cfg.num_layers, self.cfg.num_kv_heads, self.cfg.d_head
        return L * 2 * self.page * nkv * dh * self.k_pool.element_size()

    # ------------------------------------------------------------ writes
    @torch.no_grad()
    def write_tokens(self, layer_kv: Tuple[torch.Tensor, torch.Tensor],
                     logical_pages: np.ndarray, start_pos: int) -> None:
        """Scatter T tokens (k, v: [L, B, T, nkv, dh], from prefill) into
        the pages ``logical_pages`` [B, n] and fold them into the pages'
        summaries. A host loop over pages, as in the reference."""
        k, v = layer_kv
        L, B, T, nkv, dh = k.shape
        p = self.page
        for b in range(B):
            for j in range((start_pos + T + p - 1) // p):
                lo = max(j * p - start_pos, 0)
                hi = min((j + 1) * p - start_pos, T)
                if hi <= lo:
                    continue
                slot = int(self.slot_of[int(logical_pages[b, j])])
                off = (start_pos + lo) % p
                kb = k[:, b, lo:hi]
                vb = v[:, b, lo:hi]
                self.k_pool[:, slot, off : off + hi - lo] = kb.to(self.k_pool.dtype)
                self.v_pool[:, slot, off : off + hi - lo] = vb.to(self.v_pool.dtype)
                self.k_max[:, slot] = torch.maximum(self.k_max[:, slot], kb.amax(dim=1).float())
                self.k_min[:, slot] = torch.minimum(self.k_min[:, slot], kb.amin(dim=1).float())

    def _scrub_slots(self, slots: np.ndarray) -> None:
        """Reset the given physical slots to the free-slot state: zero K/V,
        ±inf summaries."""
        if len(slots) == 0:
            return
        s = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        self.k_pool[:, s] = 0
        self.v_pool[:, s] = 0
        self.k_max[:, s] = -torch.inf
        self.k_min[:, s] = torch.inf

    def free_pages(self, logical_pages) -> None:
        """Scrub the slots of freed logical pages (before or after the
        manager's ``free``: the slot mapping is the engine's either way)."""
        ids = np.asarray(logical_pages, np.int32)
        if ids.size == 0:
            return
        self._scrub_slots(self.slot_of[ids])

    # ------------------------------------------------------------ migration
    def apply_drained(self, promote_ids, demote_ids, manager: CentralManager) -> int:
        """Commit a drained queue batch (commit-on-completion): the manager's
        queue tick already flipped the tier metadata of exactly these pages.
        -1-padded id lists (numpy arrays or tensors, as in
        ``QueueStats.drained_promote_ids`` / ``drained_demote_ids``)."""
        return self.migrate(
            MigrationPlan(promote=_host_ids(promote_ids), demote=_host_ids(demote_ids)), manager
        )

    def migrate(self, plan: MigrationPlan, manager: CentralManager) -> int:
        """Execute a MaxMem plan: move page data across the tier boundary
        and rewrite ``slot_of``. Demotions first (they free fast slots).
        Four ``page_move`` calls (K, V and the two summaries) for all layers
        at once. Returns the number of pages moved."""
        promote = _host_ids(plan.promote)
        demote = _host_ids(plan.demote)
        promote = promote[promote >= 0]
        demote = demote[demote >= 0]
        if len(promote) == 0 and len(demote) == 0:
            return 0

        # slot_of is a permutation: "free" slots are those whose logical
        # holder is unallocated in the manager. Moving a page swaps its
        # mapping with such a holder (whose slot content is stale).
        owner = manager.owners()
        inv = np.empty_like(self.slot_of)
        inv[self.slot_of] = np.arange(self.n_slots, dtype=np.int32)
        free_fast = [s for s in range(self.n_fast) if owner[inv[s]] < 0]
        free_slow = [s for s in range(self.n_fast, self.n_slots) if owner[inv[s]] < 0]

        moves_src: List[int] = []
        moves_dst: List[int] = []

        def _swap(pg: int, dst: int) -> int:
            src = int(self.slot_of[pg])
            holder = int(inv[dst])  # unallocated logical page holding dst
            self.slot_of[pg] = dst
            self.slot_of[holder] = src
            inv[dst] = pg
            inv[src] = holder
            moves_src.append(src)
            moves_dst.append(dst)
            return src

        for pg in demote:
            if int(self.slot_of[pg]) >= self.n_fast:
                continue  # already slow (idempotent)
            if not free_slow:
                break
            free_fast.append(_swap(int(pg), free_slow.pop()))
        for pg in promote:
            if int(self.slot_of[pg]) < self.n_fast:
                continue
            if not free_fast:
                break  # plan over-eager for the slots actually available
            free_slow.append(_swap(int(pg), free_fast.pop()))
        if not moves_src:
            return 0

        L, n = self.cfg.num_layers, self.n_slots
        # expand page moves across layers: row id = l * n_slots + slot
        layer_base = np.arange(L, dtype=np.int64)[:, None] * n
        src_all = (layer_base + np.asarray(moves_src)[None, :]).reshape(-1)
        dst_all = (layer_base + np.asarray(moves_dst)[None, :]).reshape(-1)
        src_t = torch.as_tensor(src_all.astype(np.int32), device=self.device)
        dst_t = torch.as_tensor(dst_all.astype(np.int32), device=self.device)
        for pool in (self.k_pool, self.v_pool, self.k_max, self.k_min):
            ops.page_move(pool.view(L * n, -1), src_t, dst_t)
        # page_move is a gather: a swapped-out source row keeps a stale copy
        # of the migrated page. Rows now held by a free logical page are
        # re-scrubbed, or the free/reuse invariant breaks.
        self._scrub_slots(np.asarray([r for r in moves_src if owner[inv[r]] < 0], np.int32))
        return len(moves_src)

    # ------------------------------------------------------------ telemetry
    def read_page(self, logical_page: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copies of one logical page's (k, v) contents, [L, page, nkv, dh]
        each on the pools' device, wherever the page physically lives."""
        slot = int(self.slot_of[int(logical_page)])
        return self.k_pool[:, slot].clone(), self.v_pool[:, slot].clone()
