"""MaxMem core state, as NamedTuples of torch tensors.

The policy state lives in fixed-size tensors so one epoch is one pass of
plain tensor functions (``repro_torch.core.policy.epoch_step``). Tenants are
slots in [0, max_tenants); pages are slots in a global pool [0, num_pages).

Tier encoding per page: -1 unallocated, 0 slow, 1 fast.

Dtype decision (made first, because torch lacks pieces the reference uses):

* torch has no ``+``, ``>>``, ``>=``, ``index_add_`` or ``scatter_add_`` on
  ``uint32``. The reference's u32 leaves (``PageState.count``,
  ``PolicyState.pending``) are therefore held as **int64** carrying a u32
  value; every site where the reference relies on u32 wrap masks with
  :data:`MASK32`.
* torch cannot index with ``int16``. ``PageState.owner`` stays **int16** in
  storage (the reference's packed layout) and is upcast to int64 before it
  indexes anything.
* Index tensors built by the port (``OwnerSegments``) are int64; the
  reference holds them as i32.
* Float scalars of :class:`PolicyParams` are float32 values (rounded through
  ``numpy.float32``), and every formula that combines them is evaluated in
  float32, as the reference's traced f32 scalars are.

:func:`state_nbytes` reports the reference's packed layout (u32, i16, i32),
not the widened torch one, so byte budgets stay comparable.
:func:`state_from_numpy` / :func:`state_to_numpy` carry a ``PolicyState``
across as numpy arrays in the reference's dtypes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

TIER_NONE = -1
TIER_SLOW = 0
TIER_FAST = 1

# Migration-queue entry directions (core/policy.py data plane).
DIR_NONE = 0
DIR_PROMOTE = 1
DIR_DEMOTE = -1

# PolicyParams.migration_bandwidth sentinel: drain the whole queue per epoch.
BANDWIDTH_UNLIMITED = -1

# Widest tenant slot index an int16 ``PageState.owner`` can carry.
MAX_TENANT_SLOTS = 32767

# u32 values held in int64 tensors are reduced modulo 2^32 with this mask.
MASK32 = 0xFFFFFFFF
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


def f32(x) -> float:
    """``x`` rounded to float32, returned as a Python float (exact)."""
    return float(np.float32(x))


def knob_f32(x):
    """A float knob in float32: a float32 tensor for a tensor (one value per
    machine of a fleet, batched by ``vmap``), else :func:`f32` of it."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return f32(x)


def pick(cond, a, b):
    """``a if cond else b`` for a condition on a knob: ``torch.where`` when
    the condition is a tensor."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def knob_max(x, lo: int):
    """``max(x, lo)`` for an integer knob, a tensor or a Python int."""
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, min=lo)
    return max(x, lo)


def knob_min(x: torch.Tensor, cap) -> torch.Tensor:
    """``x`` clamped from above by a knob, a tensor or a Python scalar."""
    if isinstance(cap, torch.Tensor):
        return torch.minimum(x, cap)
    return torch.clamp(x, max=cap)


class PolicyParams(NamedTuple):
    """Knobs of the paper's policy (§3.1/§3.2) in page units.

    A manager holds plain Python scalars, so reading a knob never
    synchronises with the card; float fields hold float32 values. A fleet
    (``core/fleet.py``) stacks its machines' knobs into tensors with a
    leading machine axis, which ``vmap`` hands to the tick as 0-d tensors:
    every read of a knob in the tick takes either form (:func:`knob_f32`,
    :func:`pick`, :func:`knob_max`) and computes the same bits."""

    fast_capacity: int
    migration_budget: int
    num_bins: int = 6
    ewma_lambda: float = 0.5
    sample_period: int = 100
    fair_mode: bool = False
    hysteresis: float = f32(0.08)
    migration_bandwidth: int = BANDWIDTH_UNLIMITED
    migration_latency: int = 0
    sentinel: int = 0
    alloc_headroom: int = 0
    promote_band: float = -1.0
    demote_band: float = -1.0
    promote_admission: int = -1
    demote_cooldown: int = 0

    @classmethod
    def from_profile(cls, name: str, **overrides) -> "PolicyParams":
        """Load a committed tuned profile from ``repro_torch.configs.tuned``
        (e.g. ``"thrash_4k"``): every field in the manager's form, float
        knobs rounded to float32; keyword ``overrides`` replace fields."""
        # lazy import: configs.tuned needs PolicyParams itself
        from repro_torch.configs.tuned import params_from_profile

        return params_from_profile(name, **overrides)


class TenantState(NamedTuple):
    """Per-tenant QoS state. Tensors of length max_tenants."""

    active: torch.Tensor  # bool[T]
    t_miss: torch.Tensor  # f32[T] target FMMR in (0, 1]
    a_miss: torch.Tensor  # f32[T] EWMA of achieved FMMR
    arrival: torch.Tensor  # i32[T] arrival order (FCFS tie-break)
    cool_epoch: torch.Tensor  # i32[T] per-tenant cooling counter
    flagged: torch.Tensor  # bool[T] cannot meet target

    @classmethod
    def create(cls, max_tenants: int, device) -> "TenantState":
        T = max_tenants
        return cls(
            active=torch.zeros(T, dtype=torch.bool, device=device),
            t_miss=torch.ones(T, dtype=torch.float32, device=device),
            a_miss=torch.zeros(T, dtype=torch.float32, device=device),
            arrival=torch.full((T,), INT32_MAX, dtype=torch.int32, device=device),
            cool_epoch=torch.zeros(T, dtype=torch.int32, device=device),
            flagged=torch.zeros(T, dtype=torch.bool, device=device),
        )

    def clear_slot(self, slot: int) -> "TenantState":
        """A copy with one slot reset to its creation defaults."""
        out = TenantState(*(x.clone() for x in self))
        out.active[slot] = False
        out.t_miss[slot] = 1.0
        out.a_miss[slot] = 0.0
        out.arrival[slot] = INT32_MAX
        out.cool_epoch[slot] = 0
        out.flagged[slot] = False
        return out


class PageState(NamedTuple):
    """Per-page metadata. Tensors of length num_pages (see the module
    docstring for the widened ``count``)."""

    owner: torch.Tensor  # i16[P] tenant slot, -1 if unallocated
    tier: torch.Tensor  # i8[P]
    count: torch.Tensor  # i64[P] holding the reference's u32 count
    last_cool: torch.Tensor  # i32[P] owner cool_epoch at last count update

    @classmethod
    def create(cls, num_pages: int, device) -> "PageState":
        P = num_pages
        return cls(
            owner=torch.full((P,), -1, dtype=torch.int16, device=device),
            tier=torch.full((P,), TIER_NONE, dtype=torch.int8, device=device),
            count=torch.zeros(P, dtype=torch.int64, device=device),
            last_cool=torch.zeros(P, dtype=torch.int32, device=device),
        )


class OwnerSegments(NamedTuple):
    """Host-maintained owner-sorted page permutation: page ids sorted by
    (owner, page id), unowned pages last. Inside the tick every per-tenant
    reduction is a gather into this order plus one global cumsum."""

    order: torch.Tensor  # i64[P] page ids sorted by (owner, id); unowned last
    inv: torch.Tensor  # i64[P] inverse permutation: inv[order[i]] = i
    start: torch.Tensor  # i64[T+1] first sorted index per tenant

    @classmethod
    def from_host(cls, order, inv, start, device) -> "OwnerSegments":
        def up(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return cls(order=up(order), inv=up(inv), start=up(start))

    @classmethod
    def build(cls, owner, max_tenants: int, device=None) -> "OwnerSegments":
        """Host rebuild from an owner array (numpy or a tensor), on
        ``device``: by default the owner tensor's, and for a numpy owner
        the card (``manager.resolve_device``, which raises where there is
        none), as the reference's lands on the default device."""
        if isinstance(owner, torch.Tensor):
            device = owner.device if device is None else device
            owner = owner.cpu().numpy()
        elif device is None:
            from repro_torch.core.manager import resolve_device

            device = resolve_device(None, what="OwnerSegments.build")
        return cls.from_host(*segments_build_host(owner, max_tenants), device=device)


def segments_build_host(owner, max_tenants: int):
    """From-scratch ``(order, inv, start)`` host arrays for an owner array
    — one stable argsort."""
    own = np.asarray(owner)
    key = np.where(own >= 0, own, max_tenants)
    order = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    counts = np.bincount(key, minlength=max_tenants + 1)
    start = np.zeros((max_tenants + 1,), np.int32)
    np.cumsum(counts[:max_tenants], out=start[1:])
    return order, inv, start


def segments_update_host(order, inv, start, prev_owner, new_owner, changed, max_tenants):
    """Patch ``(order, inv, start)`` for the pages in ``changed`` whose
    owner moved from ``prev_owner`` to ``new_owner``; bit-identical to
    :func:`segments_build_host` on ``new_owner``.

    Changed entries are deleted from their old sorted positions, re-keyed,
    sorted among themselves and merged back by binary search inside their
    destination segment; only the window spanned by the affected segments
    is touched. ``changed`` holds each mutated page id once.
    """
    P = order.shape[0]
    T = max_tenants
    changed = np.asarray(changed, np.int64)
    old_k = np.where(prev_owner[changed] >= 0, prev_owner[changed], T).astype(np.int64)
    new_k = np.where(new_owner[changed] >= 0, new_owner[changed], T).astype(np.int64)

    bounds = np.concatenate([start.astype(np.int64), [np.int64(P)]])
    k_lo = int(min(old_k.min(), new_k.min()))
    k_hi = int(max(old_k.max(), new_k.max()))
    lo = int(bounds[k_lo])
    hi = int(bounds[k_hi + 1])

    win = order[lo:hi]
    rm_local = np.sort(inv[changed]) - lo
    kept_win = np.delete(win, rm_local)
    rem_counts = np.bincount(old_k - k_lo, minlength=k_hi - k_lo + 1)
    wb = bounds[k_lo : k_hi + 2] - lo
    kept_wb = wb - np.concatenate([[0], np.cumsum(rem_counts)])

    ins_sort = np.argsort(new_k * np.int64(P) + changed, kind="stable")
    changed_sorted = changed[ins_sort].astype(np.int32)
    keys_sorted = new_k[ins_sort]
    pos = np.empty(changed_sorted.shape[0], np.int64)
    seg_ids, run_starts = np.unique(keys_sorted, return_index=True)
    run_ends = np.append(run_starts[1:], keys_sorted.shape[0])
    for k, rlo, rhi in zip(seg_ids, run_starts, run_ends):
        kw = int(k) - k_lo
        seg = kept_win[kept_wb[kw] : kept_wb[kw + 1]]
        pos[rlo:rhi] = kept_wb[kw] + np.searchsorted(seg, changed_sorted[rlo:rhi])
    new_win = np.insert(kept_win, pos, changed_sorted)

    new_order = order.copy()
    new_order[lo:hi] = new_win
    new_inv = inv.copy()
    new_inv[new_win] = np.arange(lo, hi, dtype=np.int32)

    counts = np.concatenate([np.diff(start), [np.int32(P) - start[T]]]).astype(np.int64)
    np.add.at(counts, new_k, 1)
    np.add.at(counts, old_k, -1)
    new_start = np.zeros((T + 1,), np.int32)
    new_start[1:] = np.cumsum(counts[:T]).astype(np.int32)
    return new_order, new_inv, new_start


class MigrationQueue(NamedTuple):
    """Fixed-shape in-flight migration queue. Array order IS FIFO order;
    ``page == -1`` marks an empty slot."""

    page: torch.Tensor  # i32[Q] page id, -1 = empty slot
    direction: torch.Tensor  # i8[Q] DIR_PROMOTE / DIR_DEMOTE / DIR_NONE
    enqueue_epoch: torch.Tensor  # i32[Q]
    complete_epoch: torch.Tensor  # i32[Q] first epoch the entry may commit
    heat: torch.Tensor  # i8[Q] hotness bin at enqueue (thrashing guard)

    @classmethod
    def create(cls, size: int, device) -> "MigrationQueue":
        return cls(
            page=torch.full((size,), -1, dtype=torch.int32, device=device),
            direction=torch.zeros(size, dtype=torch.int8, device=device),
            enqueue_epoch=torch.zeros(size, dtype=torch.int32, device=device),
            complete_epoch=torch.zeros(size, dtype=torch.int32, device=device),
            heat=torch.zeros(size, dtype=torch.int8, device=device),
        )

    @property
    def size(self) -> int:
        return self.page.shape[0]

    @property
    def depth(self) -> torch.Tensor:
        """Occupied slots (0-d int64 tensor on the queue's device)."""
        return (self.page >= 0).sum()


class QueueStats(NamedTuple):
    """Per-epoch migration-queue telemetry. Conservation contract:
    cumulative enqueued == drained + cancelled + dropped + current depth.
    The drained id lists are [W] (W = queue capacity + both plan sides),
    padded with -1."""

    depth: torch.Tensor
    enqueued: torch.Tensor
    drained_promote: torch.Tensor
    drained_demote: torch.Tensor
    cancelled: torch.Tensor
    dropped: torch.Tensor
    drained_promote_ids: Optional[torch.Tensor]  # i64[W], -1 pad
    drained_demote_ids: Optional[torch.Tensor]  # i64[W], -1 pad


class PolicyState(NamedTuple):
    """The complete policy-engine state threaded through epochs.

    ``rng`` is a ``torch.Generator`` on the state's device: the sampler's
    deviates come from it (they cannot match the reference's threefry
    draws; exact sampling draws nothing)."""

    pages: PageState
    tenants: TenantState
    pending: torch.Tensor  # i64[P] holding the reference's u32 backlog
    rng: Optional[torch.Generator]
    queue: Optional[MigrationQueue] = None  # None == zero-capacity queue
    epoch: Optional[torch.Tensor] = None  # i32[] epoch counter (queue clock)
    segs: Optional[OwnerSegments] = None

    @classmethod
    def create(
        cls, num_pages: int, max_tenants: int, seed: int = 0, queue_size: int = 0,
        *, device,
    ) -> "PolicyState":
        if max_tenants > MAX_TENANT_SLOTS:
            raise ValueError(
                f"max_tenants {max_tenants} exceeds the int16 owner width "
                f"({MAX_TENANT_SLOTS})"
            )
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(
            pages=PageState.create(num_pages, device),
            tenants=TenantState.create(max_tenants, device),
            pending=torch.zeros(num_pages, dtype=torch.int64, device=device),
            rng=gen,
            queue=MigrationQueue.create(queue_size, device),
            epoch=torch.zeros((), dtype=torch.int32, device=device),
        )


class MigrationPlan(NamedTuple):
    """Bounded page-move lists: i64[R] page ids padded with -1."""

    promote: torch.Tensor
    demote: torch.Tensor

    @property
    def num_promote(self) -> torch.Tensor:
        return (self.promote >= 0).sum()

    @property
    def num_demote(self) -> torch.Tensor:
        return (self.demote >= 0).sum()


class EpochStats(NamedTuple):
    """Telemetry emitted each epoch (per tenant unless noted)."""

    fmmr_now: torch.Tensor  # f32[T]
    fmmr_ewma: torch.Tensor  # f32[T]
    fast_pages: torch.Tensor  # i64[T]
    slow_pages: Optional[torch.Tensor]  # i64[T]
    promoted: torch.Tensor  # i64[T]
    demoted: torch.Tensor  # i64[T]
    cooled: Optional[torch.Tensor]  # bool[T]
    queue: Optional[QueueStats] = None
    sentinel: Optional[torch.Tensor] = None  # i32[] SENTINEL_* bitmask


# ------------------------------------------------------------ the layout
# Item sizes of the reference's packed layout for the leaves the port widens.
_REF_ITEMSIZE = {
    ("PageState", "count"): 4,
    ("PolicyState", "pending"): 4,
    ("OwnerSegments", "order"): 4,
    ("OwnerSegments", "inv"): 4,
    ("OwnerSegments", "start"): 4,
}
_REF_RNG_BYTES = 8  # the reference's PRNG key is u32[2]


def state_nbytes(tree) -> int:
    """Total array bytes of a state tree, counted in the reference's packed
    layout (u32 counts, i16 owner, i32 segments; the generator counts as
    the reference's 8-byte key). Python scalars and ``None`` count zero."""

    def walk(node, owner_name, field):
        if node is None:
            return 0
        if isinstance(node, torch.Generator):
            return _REF_RNG_BYTES
        if isinstance(node, torch.Tensor):
            item = _REF_ITEMSIZE.get((owner_name, field), node.element_size())
            return node.numel() * item
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            name = type(node).__name__
            return sum(walk(v, name, f) for f, v in zip(node._fields, node))
        if isinstance(node, (tuple, list)):
            return sum(walk(v, owner_name, field) for v in node)
        return 0

    return walk(tree, None, None)


# --------------------------------------------------- numpy in and out
def _np(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype)


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(dtype), device=device)


def state_from_numpy(ref, device) -> PolicyState:
    """A :class:`PolicyState` on ``device`` from a reference state whose
    leaves are numpy arrays (``jax.device_get`` of the reference's
    ``PolicyState``, or anything with the same attributes).

    The reference's PRNG key cannot drive a torch generator bit-for-bit;
    the generator is seeded from the key's two words."""
    p, tn = ref.pages, ref.tenants
    pages = PageState(
        owner=_t(p.owner, np.int16, device),
        tier=_t(p.tier, np.int8, device),
        count=_t(np.asarray(p.count).astype(np.uint32), np.int64, device),
        last_cool=_t(p.last_cool, np.int32, device),
    )
    tenants = TenantState(
        active=_t(tn.active, np.bool_, device),
        t_miss=_t(tn.t_miss, np.float32, device),
        a_miss=_t(tn.a_miss, np.float32, device),
        arrival=_t(tn.arrival, np.int32, device),
        cool_epoch=_t(tn.cool_epoch, np.int32, device),
        flagged=_t(tn.flagged, np.bool_, device),
    )
    queue = None
    if getattr(ref, "queue", None) is not None:
        q = ref.queue
        queue = MigrationQueue(
            page=_t(q.page, np.int32, device),
            direction=_t(q.direction, np.int8, device),
            enqueue_epoch=_t(q.enqueue_epoch, np.int32, device),
            complete_epoch=_t(q.complete_epoch, np.int32, device),
            heat=_t(q.heat, np.int8, device),
        )
    epoch = None
    if getattr(ref, "epoch", None) is not None:
        epoch = _t(ref.epoch, np.int32, device)
    segs = None
    if getattr(ref, "segs", None) is not None:
        s = ref.segs
        segs = OwnerSegments.from_host(s.order, s.inv, s.start, device)
    key = np.asarray(ref.rng).astype(np.uint64).ravel()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key[0]) << 32 | int(key[-1]))
    return PolicyState(
        pages=pages, tenants=tenants,
        pending=_t(np.asarray(ref.pending).astype(np.uint32), np.int64, device),
        rng=gen, queue=queue, epoch=epoch, segs=segs,
    )


def state_to_numpy(state: PolicyState) -> PolicyState:
    """The state's tensors as numpy arrays in the reference's dtypes (u32
    count and pending, i16 owner, i32 segments); ``rng`` becomes ``None``."""
    p, tn = state.pages, state.tenants
    pages = PageState(
        owner=_np(p.owner, np.int16), tier=_np(p.tier, np.int8),
        count=_np(p.count, np.int64).astype(np.uint32),
        last_cool=_np(p.last_cool, np.int32),
    )
    tenants = TenantState(
        active=_np(tn.active, np.bool_), t_miss=_np(tn.t_miss, np.float32),
        a_miss=_np(tn.a_miss, np.float32), arrival=_np(tn.arrival, np.int32),
        cool_epoch=_np(tn.cool_epoch, np.int32), flagged=_np(tn.flagged, np.bool_),
    )
    queue = None
    if state.queue is not None:
        q = state.queue
        queue = MigrationQueue(
            page=_np(q.page, np.int32), direction=_np(q.direction, np.int8),
            enqueue_epoch=_np(q.enqueue_epoch, np.int32),
            complete_epoch=_np(q.complete_epoch, np.int32),
            heat=_np(q.heat, np.int8),
        )
    segs = None
    if state.segs is not None:
        s = state.segs
        segs = OwnerSegments(
            order=_np(s.order, np.int32), inv=_np(s.inv, np.int32),
            start=_np(s.start, np.int32),
        )
    return PolicyState(
        pages=pages, tenants=tenants,
        pending=_np(state.pending, np.int64).astype(np.uint32),
        rng=None, queue=queue,
        epoch=None if state.epoch is None else _np(state.epoch, np.int32),
        segs=segs,
    )
