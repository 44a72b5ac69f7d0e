"""Fault injection + the invariant sentinel, host half.

  * :class:`FaultInjector` — seeded, probabilistic page-move failures for
    the pool-backed data plane (``PagePool``), with bounded retry and
    exponential backoff. Its draws come from numpy's PCG64, so a seed gives
    the same failures as the reference's injector.
  * :func:`validate_state` / :func:`deep_validate` — the host-side deep
    validator behind the tick's cheap sentinel bitmask.
  * :class:`SentinelError` — raised on detection.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.types import TIER_FAST, TIER_NONE, TIER_SLOW, segments_build_host

# Violation bitmask emitted by the tick (policy._sentinel_bits) and by the
# host validator below. 0 == green.
SENTINEL_OCCUPANCY = 1  # fast-tier occupancy exceeds fast_capacity
SENTINEL_QUEUE = 2  # queue flow: depth' != depth + enq - drain - cancel - drop
SENTINEL_OWNERSHIP = 4  # owned <-> placed mismatch
SENTINEL_ORPHAN = 8  # page owned by an inactive tenant slot
SENTINEL_NAN = 16  # non-finite FMMR EWMA


class SentinelError(RuntimeError):
    """An invariant the engine promises unconditionally was violated."""


@dataclasses.dataclass
class FaultInjector:
    """Seeded probabilistic failures for ``PagePool`` page moves: each move
    fails with probability ``move_fail_rate`` and is retried after a backoff
    of ``backoff_base_s * 2**attempt``, up to ``max_retries`` retries.
    ``sleep=None`` records the backoff without sleeping."""

    move_fail_rate: float = 0.0
    max_retries: int = 3
    backoff_base_s: float = 1e-3
    seed: int = 0
    sleep: Optional[Callable[[float], None]] = None
    attempts: int = 0
    failures: int = 0
    retries: int = 0
    gave_up: int = 0
    no_frame: int = 0
    backoff_total_s: float = 0.0

    def __post_init__(self):
        rate = float(self.move_fail_rate)
        if math.isnan(rate) or not (0.0 <= rate <= 1.0):
            raise ValueError(f"move_fail_rate must be in [0, 1], got {self.move_fail_rate}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not (self.backoff_base_s >= 0.0):
            raise ValueError("backoff_base_s must be >= 0")
        self._rng = np.random.default_rng(self.seed)

    def attempt_move(self) -> bool:
        """One page move through the retry loop: True = committed."""
        for attempt in range(self.max_retries + 1):
            self.attempts += 1
            if self._rng.random() >= self.move_fail_rate:
                return True
            self.failures += 1
            if attempt < self.max_retries:
                self.retries += 1
                delay = self.backoff_base_s * (2.0**attempt)
                self.backoff_total_s += delay
                if self.sleep is not None:
                    self.sleep(delay)
        self.gave_up += 1
        return False

    def counters(self) -> dict:
        return {
            "attempts": self.attempts,
            "failures": self.failures,
            "retries": self.retries,
            "gave_up": self.gave_up,
            "no_frame": self.no_frame,
            "backoff_total_s": self.backoff_total_s,
        }


def validate_state(
    tier: np.ndarray,
    owner: np.ndarray,
    fast_capacity: int,
    max_tenants: int,
    active: Optional[np.ndarray] = None,
    a_miss: Optional[np.ndarray] = None,
    queue_counters: Optional[dict] = None,
) -> List[str]:
    """Pure-array invariant checks; returns violation strings (empty == green)."""
    tier = np.asarray(tier)
    owner = np.asarray(owner)
    out: List[str] = []
    if not np.isin(tier, (TIER_NONE, TIER_SLOW, TIER_FAST)).all():
        out.append("tier outside {-1, 0, 1}")
    owned = owner >= 0
    placed = tier != TIER_NONE
    if (owned != placed).any():
        out.append(f"{int((owned != placed).sum())} pages with owner<->placement mismatch")
    if (owner >= max_tenants).any() or (owner < -1).any():
        out.append("owner outside [-1, max_tenants)")
    fast_occ = int((tier == TIER_FAST).sum())
    if fast_occ > int(fast_capacity):
        out.append(f"fast occupancy {fast_occ} > capacity {int(fast_capacity)}")
    if active is not None:
        act = np.asarray(active)
        orphan = owned & ~act[np.clip(owner, 0, max_tenants - 1)]
        if orphan.any():
            out.append(f"{int(orphan.sum())} pages owned by inactive tenants")
    if a_miss is not None and not np.isfinite(np.asarray(a_miss)).all():
        out.append("non-finite FMMR EWMA")
    if queue_counters is not None:
        q = queue_counters
        lhs = q["enqueued"]
        rhs = q["drained"] + q["cancelled"] + q["dropped"] + q["depth"]
        if lhs != rhs:
            out.append(f"queue conservation: enqueued {lhs} != {rhs}")
    return out


def deep_validate(manager, raise_on_violation: bool = True) -> List[str]:
    """Host-side deep validator for a ``CentralManager``: placements,
    tenants, queue counters, owner segments and the page pool."""
    tier = np.asarray(manager.tiers())
    owner = np.asarray(manager.owners())
    active = manager.tenants.active.cpu().numpy()
    a_miss = manager.tenants.a_miss.cpu().numpy()
    qc = manager.queue_counters() if hasattr(manager, "queue_counters") else None
    out = validate_state(
        tier, owner, int(manager.params.fast_capacity), manager.max_tenants,
        active=active, a_miss=a_miss, queue_counters=qc,
    )
    segs = getattr(manager._state, "segs", None)
    if segs is not None and manager._segs_owner is None:
        order, _, start = segments_build_host(owner, manager.max_tenants)
        if not (
            np.array_equal(segs.order.cpu().numpy(), order)
            and np.array_equal(segs.start.cpu().numpy(), start)
        ):
            out.append("owner segments stale vs owner array")
    pool = getattr(manager, "pool", None)
    if pool is not None:
        try:
            pool.check(tier)
        except AssertionError as e:
            out.append(f"data plane: {e}")
    if out and raise_on_violation:
        raise SentinelError("; ".join(out))
    return out
