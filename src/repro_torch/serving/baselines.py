"""Serving-side placement baselines (the reference's ``serving/baselines.py``).

``FixedPartitionManager`` is the HeMem-style static KV partition: every
tenant gets a fixed fast-tier quota carved out at registration, first-touch
allocation fills the tenant's own quota (never another tenant's), and no
migration reshuffles placement afterwards. This is what a per-tenant
reserved-HBM serving deployment gives you; the colocation benchmark runs it
as the provisioned-for-peak reference the paper's FMMR control beats: the
partition can neither lend idle fast pages to a bursting LS tenant nor
reclaim them from an idle BE tenant.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.manager import CentralManager, TenantHandle
from repro_torch.core.types import TIER_FAST, TIER_NONE, TIER_SLOW


class FixedPartitionManager(CentralManager):
    """A :class:`CentralManager` whose fast tier is statically partitioned.

    ``fast_quota`` maps tenant handle -> fast pages reserved for it;
    :meth:`register_with_quota` assigns quotas as tenants arrive, and
    ``named_quota`` (tenant name -> pages) is resolved onto handles by the
    ``OpenLoopDriver`` as it registers the tenants. Tenants without a quota
    allocate slow-only. Construct with a zero-drain queue
    (``migration_bandwidth=0``) or ``migration_budget=0`` so the partition
    stays frozen; allocation is the only placement mechanism.
    """

    def __init__(self, *args, named_quota: Optional[Dict[str, int]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.fast_quota: Dict[int, int] = {}
        self.named_quota: Dict[str, int] = dict(named_quota or {})

    @property
    def _named_quota(self) -> Dict[str, int]:
        """The reference's name for ``named_quota``: its
        ``make_serving_manager`` sets ``_named_quota`` after construction, so
        code written that way reaches the same quotas here."""
        return self.named_quota

    @_named_quota.setter
    def _named_quota(self, value: Dict[str, int]) -> None:
        self.named_quota = dict(value or {})

    def register_with_quota(self, t_miss: float, fast_quota: int) -> TenantHandle:
        h = self.register(t_miss)
        self.fast_quota[int(h)] = int(fast_quota)
        return h

    def allocate(self, h: TenantHandle, n_pages: int) -> np.ndarray:
        """First-touch within the tenant's own fast partition, then slow."""
        snap = self._snapshot()
        tier = snap["tier"]
        owner = snap["owner"]
        unalloc = np.flatnonzero(tier == TIER_NONE)
        if len(unalloc) < n_pages:
            raise MemoryError(
                f"tenant {int(h)}: out of tiered memory "
                f"({n_pages} requested, {len(unalloc)} free)"
            )
        quota = self.fast_quota.get(int(h), 0)
        mine_fast = int(((owner == int(h)) & (tier == TIER_FAST)).sum())
        fast_used = int((tier == TIER_FAST).sum())
        fast_room = min(
            max(quota - mine_fast, 0),
            max(int(self.params.fast_capacity) - fast_used, 0),
        )
        take = unalloc[:n_pages]
        n_fast = min(fast_room, n_pages)
        new_tier = tier.copy()
        new_owner = owner.copy()
        new_tier[take[:n_fast]] = TIER_FAST
        new_tier[take[n_fast:]] = TIER_SLOW
        new_owner[take] = int(h)
        self._set_pages_churn(
            self.pages._replace(tier=self._upload(new_tier), owner=self._upload(new_owner)),
            take,
        )
        if self.pool is not None:
            self.pool.on_allocate(take, new_tier[take])
        return take


def make_serving_manager(
    mode: str,
    *,
    num_pages: int,
    fast_capacity: int,
    migration_budget: int,
    queue_size: int,
    migration_bandwidth: Optional[int] = None,
    migration_latency: int = 0,
    fast_quota: Optional[Dict[str, int]] = None,
    alloc_headroom: int = 0,
    max_tenants: int = 8,
    seed: int = 0,
    device=None,
) -> CentralManager:
    """One constructor for the three benchmark placements, with identical
    ``num_pages`` / ``max_tenants`` / ``queue_size`` / ``plan_size``; only
    the ``PolicyParams`` differ. ``device`` as for :class:`CentralManager`
    (``None`` = the card).

      * ``maxmem``: queue-mode bounded-bandwidth FMMR control, with a
        TPP-style ``alloc_headroom`` fast-page reserve for first-touch
        allocations;
      * ``static``: the same with ``migration_bandwidth=0``: selections
        enqueue but never drain, so first-touch placement stays frozen;
      * ``fixed``: :class:`FixedPartitionManager`, also zero-drain, with
        per-tenant fast quotas (``fast_quota``, by tenant name) applied at
        allocation.
    """
    kw = dict(
        num_pages=num_pages,
        fast_capacity=fast_capacity,
        migration_budget=migration_budget,
        max_tenants=max_tenants,
        sample_period=1,
        exact_sampling=True,
        queue_size=queue_size,
        migration_latency=migration_latency,
        seed=seed,
        device=device,
    )
    if mode == "maxmem":
        return CentralManager(
            migration_bandwidth=migration_bandwidth,
            alloc_headroom=alloc_headroom,
            **kw,
        )
    if mode == "static":
        return CentralManager(migration_bandwidth=0, **kw)
    if mode == "fixed":
        return FixedPartitionManager(migration_bandwidth=0, named_quota=fast_quota, **kw)
    raise ValueError(f"unknown serving manager mode: {mode!r}")
