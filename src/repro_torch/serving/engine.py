"""Multi-tenant serving engine over the tiered paged KV cache (PyTorch).

Continuous batching, as in the reference's ``serving/engine.py``: requests
from several tenants (each with its own MaxMem ``t_miss`` target) share one
fixed decode batch. Every step:

  1. admit queued requests into free batch lanes (prefill -> pages); a
     request whose pages cannot be allocated yet waits (backpressure) in
     FIFO order without blocking smaller requests behind it
  2. one batched paged-decode step (Quest top-k page selection, attention
     through the paged attention kernel)
  3. report the selected-page access stream to the central manager
  4. on page-boundary crossings, first-touch allocate new pages
  5. every ``epoch_steps`` decode steps: run the MaxMem epoch. With a
     queue-mode manager the epoch's drained batch is committed to the KV
     pools (commit-on-completion); an instant-apply manager executes the
     whole plan. Either way ``page_move`` does the copies.
  6. finished sequences free their pages and scrub their KV slots

A step-latency model (fast vs slow page reads) attributes per-tenant decode
latency so benchmarks can read p50/p99 per tenant.

The model, the pools and the manager live on one device, the card unless
they were built on the CPU.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.manager import CentralManager, TenantHandle
from repro_torch.core.types import TIER_FAST
from repro_torch.kvcache.paged import TieredPagedKV
from repro_torch.models.model import get_model
from repro_torch.serving.paged_model import PagedPools, paged_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    tenant: str
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    # runtime
    generated: List[int] = dataclasses.field(default_factory=list)
    lane: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = 0
    admit_step: int = -1
    finish_step: int = -1

    @property
    def queue_delay_steps(self) -> int:
        """Decode steps spent waiting for admission (backpressure)."""
        return max(self.admit_step - self.submit_step, 0)


@dataclasses.dataclass
class StepLatency:
    fast_pages: int
    slow_pages: int
    seconds: float


class ServingEngine:
    def __init__(
        self,
        cfg,
        params,
        manager: CentralManager,
        kv: TieredPagedKV,
        *,
        max_batch: int = 8,
        pages_per_seq: int = 16,
        quest_pages: int = 4,
        epoch_steps: int = 8,
        fast_page_s: float = 1e-6,
        slow_page_s: float = 20e-6,
    ):
        if manager.device != kv.device:
            raise ValueError(f"manager on {manager.device} but KV pools on {kv.device}")
        self.cfg = cfg
        self.params = params
        self.manager = manager
        self.kv = kv
        self.device = kv.device
        self.api = get_model(cfg)
        self.max_batch = max_batch
        self.n_p = pages_per_seq
        self.quest_pages = quest_pages
        self.epoch_steps = epoch_steps
        self.fast_page_s = fast_page_s
        self.slow_page_s = slow_page_s

        self.tenant_handles: Dict[str, TenantHandle] = {}
        self.queue: Deque[Request] = deque()
        self.lanes: List[Optional[Request]] = [None] * max_batch
        self.tables = np.full((max_batch, pages_per_seq), -1, np.int32)
        self.positions = np.zeros(max_batch, np.int32)
        self.step_count = 0
        self._rid = 0
        self._latencies: Dict[str, List[float]] = {}
        self._migrated_pages = 0
        self.admission_blocked = 0  # allocation-failure backpressure events
        self._epoch_log: List[dict] = []
        self.finished: List[Request] = []
        self.last_logits: Optional[torch.Tensor] = None  # [B, V] f32 of the last step
        self.prefills = 0  # prompts run through prefill
        self.decode_steps = 0  # batched decode steps run
        self.decode_tokens = 0  # tokens those steps generated (active lanes)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------- tenants
    def add_tenant(self, name: str, t_miss: float) -> None:
        self.tenant_handles[name] = self.manager.register(t_miss)
        self._latencies[name] = []

    def set_target(self, name: str, t_miss: float) -> None:
        self.manager.set_target(self.tenant_handles[name], t_miss)

    # ------------------------------------------------------------- requests
    def submit(self, tenant: str, prompt: np.ndarray, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32)
        max_tokens = self.n_p * self.kv.page
        if len(prompt) > max_tokens:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the per-sequence "
                f"page table: pages_per_seq={self.n_p} x page={self.kv.page} "
                f"= {max_tokens} tokens"
            )
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        self._rid += 1
        self.queue.append(Request(rid=self._rid, tenant=tenant, prompt=prompt,
                                  max_new_tokens=max_new_tokens, submit_step=self.step_count))
        return self._rid

    # ------------------------------------------------------------- admission
    def _admit(self) -> None:
        free_lanes = [i for i, r in enumerate(self.lanes) if r is None]
        blocked: List[Request] = []
        while free_lanes and self.queue:
            req = self.queue.popleft()
            S = len(req.prompt)
            h = self.tenant_handles[req.tenant]
            n_pages = (S + self.kv.page - 1) // self.kv.page
            try:
                pages = self.manager.allocate(h, n_pages)
            except MemoryError:
                # backpressure: the request keeps waiting (FIFO order is
                # kept below) but does not block smaller requests behind it
                self.admission_blocked += 1
                blocked.append(req)
                continue
            lane = free_lanes.pop(0)
            req.pages = list(map(int, pages))
            req.lane = lane
            req.admit_step = self.step_count
            self.lanes[lane] = req
            self.tables[lane, :] = -1
            self.tables[lane, :n_pages] = req.pages
            # prefill: forward pass collecting KV, then scatter into pages
            logits, cache = self.api.prefill(
                self.params, self._tensor(req.prompt[None, :].astype(np.int64)), S
            )
            self.prefills += 1
            self.kv.write_tokens((cache.k, cache.v), np.asarray([req.pages], np.int32),
                                 start_pos=0)
            # prefill accesses: every page of the prompt touched once
            counts = np.zeros(self.manager.num_pages, np.int64)
            counts[req.pages] += 1
            self.manager.record_access(counts)
            req.generated.append(int(torch.argmax(logits[0, 0])))
            self.positions[lane] = S  # next token index to write
        for req in reversed(blocked):
            self.queue.appendleft(req)

    # ------------------------------------------------------------- stepping
    def _ensure_page(self, lane: int) -> bool:
        """Allocate the page for the position about to be written."""
        req = self.lanes[lane]
        p_idx = int(self.positions[lane]) // self.kv.page
        if p_idx >= self.n_p:
            return False  # out of table space: finish the request
        if self.tables[lane, p_idx] >= 0:
            return True
        h = self.tenant_handles[req.tenant]
        try:
            pages = self.manager.allocate(h, 1)
        except MemoryError:
            return False
        self.tables[lane, p_idx] = int(pages[0])
        req.pages.append(int(pages[0]))
        return True

    def step(self) -> Dict[str, StepLatency]:
        self._admit()
        active_mask = np.array([r is not None for r in self.lanes])
        if not active_mask.any():
            self.step_count += 1
            return {}
        for lane, req in enumerate(self.lanes):
            if req is not None and not self._ensure_page(lane):
                self._finish(lane)
                active_mask[lane] = False
        if not active_mask.any():
            self.step_count += 1
            return {}

        tokens = np.array(
            [(r.generated[-1] if r is not None and r.generated else 0) for r in self.lanes],
            np.int64,
        )
        slot_tables = np.where(self.tables >= 0,
                               self.kv.slot_of[np.maximum(self.tables, 0)], -1)
        logits, _, counts = paged_decode_step(
            self.params,
            self._tensor(tokens),
            self._tensor(self.positions.astype(np.int64)),
            self._tensor(slot_tables.astype(np.int64)),
            self._tensor(self.tables.astype(np.int64)),
            self._tensor(active_mask),
            PagedPools(self.kv.k_pool, self.kv.v_pool, self.kv.k_max, self.kv.k_min),
            num_logical_pages=self.manager.num_pages,
            cfg=self.cfg,
            quest_pages=self.quest_pages,
        )
        self.decode_steps += 1
        self.decode_tokens += int(active_mask.sum())
        counts_np = counts.cpu().numpy().astype(np.int64)
        self.manager.record_access(counts_np)

        # ---- latency attribution: page tiers touched this step -------------
        lat: Dict[str, StepLatency] = {}
        touched = np.flatnonzero(counts_np > 0)
        owner = self.manager.owners()
        for name, h in self.tenant_handles.items():
            mine = touched[(owner[touched] == int(h))] if len(touched) else touched
            nf = int((self.manager.tier_of(mine) == TIER_FAST).sum()) if len(mine) else 0
            ns = len(mine) - nf
            sec = nf * self.fast_page_s + ns * self.slow_page_s
            if len(mine):
                lat[name] = StepLatency(fast_pages=nf, slow_pages=ns, seconds=sec)
                self._latencies[name].append(sec)

        # ---- token bookkeeping ---------------------------------------------
        self.last_logits = logits
        greedy = torch.argmax(logits, dim=-1).cpu().numpy()
        for lane, req in enumerate(self.lanes):
            if req is None or not active_mask[lane]:
                continue
            req.generated.append(int(greedy[lane]))
            self.positions[lane] += 1
            if len(req.generated) >= req.max_new_tokens:
                self._finish(lane)

        self.step_count += 1
        # ---- MaxMem epoch ----------------------------------------------------
        if self.step_count % self.epoch_steps == 0:
            res = self.manager.run_epoch()
            if res.stats.queue is not None:
                # queue mode: only the drained batch moves bytes this epoch
                q = res.stats.queue
                moved = self.kv.apply_drained(q.drained_promote_ids, q.drained_demote_ids,
                                              self.manager)
            else:
                moved = self.kv.migrate(res.plan, self.manager)
            self._migrated_pages += moved
            self._epoch_log.append({
                "step": self.step_count,
                "moved": moved,
                "queue_depth": res.queue_depth,
                "fmmr": {n: float(self.manager.fmmr_of(h))
                         for n, h in self.tenant_handles.items()},
            })
        return lat

    def _finish(self, lane: int) -> None:
        req = self.lanes[lane]
        req.finish_step = self.step_count
        h = self.tenant_handles[req.tenant]
        if req.pages:
            # scrub the KV slots before releasing the ids (free/reuse invariant)
            self.kv.free_pages(req.pages)
            self.manager.free(h, np.asarray(req.pages, np.int32))
        self.tables[lane, :] = -1
        self.positions[lane] = 0
        self.lanes[lane] = None
        self.finished.append(req)

    def run(self, n_steps: int) -> None:
        for _ in range(n_steps):
            self.step()

    # ------------------------------------------------------------- telemetry
    @property
    def migrated_bytes(self) -> int:
        """Bytes physically moved across the tier boundary so far."""
        return self._migrated_pages * self.kv.page_bytes()

    def latency_percentiles(self, tenant: str):
        xs = np.asarray(self._latencies.get(tenant, []))
        if len(xs) == 0:
            return {}
        return {
            "p50": float(np.percentile(xs, 50)),
            "p90": float(np.percentile(xs, 90)),
            "p99": float(np.percentile(xs, 99)),
            "mean": float(xs.mean()),
        }
