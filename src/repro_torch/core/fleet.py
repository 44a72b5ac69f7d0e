"""K machines advanced by one batched tick.

MaxMem's claims are statements about populations of colocation scenarios:
policy x seed x bandwidth grids. This module stacks every machine's
``PolicyState`` (pages, tenants, backlog, migration queue, owner segments)
along a leading machine axis and runs the single-epoch body
``policy._step`` under ``torch.func.vmap``: one loop over the k epochs
advances all K machines, and the telemetry of the k epochs comes to the
host in one copy per leaf.

Per-machine knobs are stacked too (``PolicyParams`` leaves of shape [K]),
so the grid may differ in seeds, budgets, bandwidth, latency, sample
period, EWMA lambda, hysteresis, fairness, bins, fast capacity and the
storm guards; page count, tenant table and queue size are shapes and must
agree. No reduction crosses machines, so each machine's rows equal what it
computes alone.

Sampling noise: each machine draws its deviates from its own
``torch.Generator`` (``policy.clt_deviates``, as ``multi_epoch`` draws
them alone), in machine order, before the batched tick; the stacked state
carries no generator. A machine's stream is therefore the same in a fleet
as alone, and a failed machine's stream stands still while it is down.

Surface:

  * :func:`fleet_multi_epoch` - the batched tick on stacked states.
  * :class:`FleetManager` - K :class:`CentralManager` control planes over
    one stacked state per device slice, with dirty tracking (a dispatch with
    no control-plane operation in between uploads nothing), lazily parked
    slices, inert padding, an asynchronous dispatch thread with supervision
    hooks, and machine failure and recovery.

Sharding: ``FleetManager(devices=[...])`` splits the padded machine axis
into one contiguous slice per device and runs :func:`fleet_multi_epoch` on
each slice on its device (the card slices first, so the card's queued
work runs while the CPU slices compute; the host work of the slices runs
one after another on the dispatch thread), then gathers the telemetry in
machine order.
No reduction crosses a machine, so every machine's rows equal the unsharded
path's. Each machine's deviates are still drawn from its own generator on
its own device and carried to its slice; a slice on another device type
than its machines runs the same integer arithmetic, but its float32
roundings are that device's, so a fleet split between the card and the CPU
is held bit-equal to the machines' own runs with exact sampling.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import dataclasses
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import policy
from repro_torch.core.manager import CentralManager, MultiEpochResult, _index_tree
from repro_torch.core.types import (
    _REF_RNG_BYTES,
    MASK32,
    EpochStats,
    MigrationPlan,
    OwnerSegments,
    PolicyParams,
    PolicyState,
    state_nbytes,
)

_FLOAT_KNOBS = ("ewma_lambda", "hysteresis", "promote_band", "demote_band")


def _knob_dtype(field: str):
    if field in _FLOAT_KNOBS:
        return np.float32
    if field == "fair_mode":
        return np.bool_
    return np.int64


def stack_params(plist: Sequence[PolicyParams], device) -> PolicyParams:
    """One [K] tensor per knob from K managers' Python-scalar params."""
    return PolicyParams(**{
        f: torch.as_tensor(
            np.asarray([getattr(p, f) for p in plist], dtype=_knob_dtype(f)), device=device
        )
        for f in PolicyParams._fields
    })


def _rebuild(node, children):
    return type(node)(*children) if hasattr(node, "_fields") else tuple(children)


def _map(fn, tree):
    """``fn`` over every tensor leaf of a tree of tuples (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return _rebuild(tree, [_map(fn, x) for x in tree])


def _map2(fn, a, b):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return _rebuild(a, [_map2(fn, x, y) for x, y in zip(a, b)])


def stack_states(states: Sequence[PolicyState]) -> PolicyState:
    """The machines' states stacked leafwise on a new leading axis; the
    stack carries no generator (``rng=None``)."""
    return policy._stack([s._replace(rng=None) for s in states])


def machine_slice(fstate: PolicyState, i: int, rng=None, device=None) -> PolicyState:
    """Machine ``i``'s row of a stacked state, copied to ``device`` (default:
    the stack's; the stack is updated in place later), with ``rng`` as its
    generator."""
    return _map(lambda a: a[i].to(device or a.device, copy=True),
                fstate._replace(rng=None))._replace(rng=rng)


def _to(tree, device):
    return _map(lambda a: a.to(device), tree)


def _cat(trees):
    """Leafwise ``torch.cat`` along the machine axis of same-shaped trees
    (one tree comes back as it is)."""
    if len(trees) == 1 or trees[0] is None:
        return trees[0]
    if isinstance(trees[0], torch.Tensor):
        return torch.cat(trees)
    return _rebuild(trees[0], [_cat(list(xs)) for xs in zip(*trees)])


def resolve_devices(devices, machine_device: torch.device) -> List[torch.device]:
    """The fleet's slice devices: ``None`` or ``1`` is the machines' device;
    an int n is ``cuda:0`` .. ``cuda:n-1`` (a ``ValueError`` when fewer are
    visible); a sequence names each device."""
    if devices is None or (isinstance(devices, int) and devices == 1):
        return [machine_device]
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices > visible:
            raise ValueError(f"requested {devices} devices, only {visible} CUDA devices visible")
        return [torch.device("cuda", i) for i in range(devices)]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs


@dataclasses.dataclass
class _Slice:
    """One device's contiguous rows [lo, hi) of the padded machine axis,
    with their stacked state and params on that device."""

    device: torch.device
    lo: int
    hi: int
    fstate: Optional[PolicyState] = None
    fparams: Optional[PolicyParams] = None


def _batch_dims(tree):
    """``vmap``'s ``in_dims`` for a tree: 0 at every tensor, None at None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return 0
    return _rebuild(tree, [_batch_dims(x) for x in tree])


def _leaves(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for child in tree for x in _leaves(child)]


def _fill(spec, it):
    """``spec`` (a tree) with each tensor leaf replaced by the next of ``it``."""
    if spec is None:
        return None
    if isinstance(spec, torch.Tensor):
        return next(it)
    return _rebuild(spec, [_fill(x, it) for x in spec])


def _vmapped_step(fstate, max_tenants, plan_size, exact_sampling, collect_plans, trim_stats,
                  has_z):
    """The batched single-epoch body. ``vmap`` returns tensors only, so the
    body hands back its outputs' leaves and the tree is rebuilt outside."""
    spec = []

    def one(st, pending, params, z):
        st2, plan, stats = policy._step(
            st, pending, params, max_tenants, plan_size, exact_sampling, collect_plans, z,
            scan=True,
        )
        if trim_stats:
            stats = policy._trim_stats(stats)
        out = (st2, plan if collect_plans else None, stats, st2.tenants.flagged)
        spec.append(out)
        return tuple(_leaves(out))

    batched = torch.func.vmap(one, in_dims=(_batch_dims(fstate), 0, 0, 0 if has_z else None))

    def step(st, pending, params, z):
        flat = batched(st, pending, params, z)
        return _fill(spec.pop(), iter(flat))

    return step


def fleet_multi_epoch(
    fstate: PolicyState,
    fparams: PolicyParams,
    counts: Optional[torch.Tensor] = None,
    *,
    k: int,
    max_tenants: int,
    plan_size: int,
    exact_sampling: bool = False,
    collect_plans: bool = False,
    trim_stats: bool = False,
    z: Optional[torch.Tensor] = None,
):
    """Advance K stacked machines by ``k`` epochs.

    ``fstate``/``fparams`` carry a leading machine axis on every leaf.
    ``counts`` is None (each machine consumes its recorded backlog),
    [K, P] (each machine replays its row every epoch) or [K, k, P]. Without
    exact sampling ``z`` [K, k, P] holds each machine's deviates. Returns
    (fstate', plans, stats, flagged) with the per-epoch outputs shaped
    [K, k, ...]; ``plans`` is None unless ``collect_plans``. ``trim_stats``
    drops the leaves ``policy._trim_stats`` names."""
    dev = fstate.pending.device
    if not exact_sampling and z is None:
        raise ValueError("sampled fleet epochs need the machines' deviates z [K, k, P]")
    if counts is not None:
        counts = counts.to(device=dev, dtype=torch.int64) & MASK32
    step = _vmapped_step(
        fstate, max_tenants, plan_size, exact_sampling, collect_plans, trim_stats, z is not None
    )
    plans, stats_k, flagged = [], [], []
    st = fstate
    for i in range(k):
        pending = st.pending
        if counts is not None:
            pending = (pending + (counts if counts.dim() == 2 else counts[:, i])) & MASK32
        st, plan, stats, flags = step(st, pending, fparams, None if z is None else z[:, i])
        plans.append(plan)
        stats_k.append(stats)
        flagged.append(flags)
    plans_out = policy._stack(plans, 1) if collect_plans else None
    return st, plans_out, policy._stack(stats_k, 1), torch.stack(flagged, 1)


@dataclasses.dataclass
class FleetMultiEpochResult:
    """Stacked output of ``FleetManager.run_epochs``: host (CPU) tensors
    with leading [K, k] axes, one copy per leaf from the card.
    ``machine(m)`` views one machine's slice as a :class:`MultiEpochResult`."""

    stats: EpochStats  # [K, k, ...] leaves
    plans: Optional[MigrationPlan]  # [K, k, R] leaves or None
    flags: np.ndarray  # bool[K, k, T]

    @property
    def num_machines(self) -> int:
        return self.flags.shape[0]

    @property
    def num_epochs(self) -> int:
        return self.flags.shape[1]

    def machine(self, m: int) -> MultiEpochResult:
        return MultiEpochResult(
            stats=_index_tree(self.stats, m),
            plans=_index_tree(self.plans, m),
            flags=self.flags[m],
        )


class DispatchError(RuntimeError):
    """The fleet's dispatch worker failed or timed out; the fleet state is
    still the one before the dispatch, and ``FleetManager.recover_dispatch``
    rolls the epoch clocks back so that the chunk can be run again."""


class _DispatchWorker:
    """The fleet's dispatch thread: a daemon draining a queue of (future,
    thunk) pairs, so a wedged dispatch never holds the interpreter at exit.
    ``close()`` (also registered with atexit) joins for at most its
    timeout; ``FleetManager.recover_dispatch`` abandons a wedged worker and
    the next dispatch starts a fresh one."""

    def __init__(self):
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._thread = threading.Thread(target=self._loop, name="fleet-dispatch", daemon=True)
        self._closed = False
        self._thread.start()
        atexit.register(self.close)

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # everything goes to the future
                fut.set_exception(e)

    def submit(self, fn) -> "concurrent.futures.Future":
        if self._closed:
            raise RuntimeError("dispatch worker is closed")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((fut, fn))
        return fut

    def close(self, timeout: float = 5.0) -> None:
        """Ask the thread to drain and exit; join at most ``timeout`` s."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        if timeout > 0:
            self._thread.join(timeout)
        try:
            atexit.unregister(self.close)
        except Exception:
            pass


class FleetPendingResult:
    """A fleet advance running on the dispatch thread.

    The worker runs the batched tick and copies the telemetry to the
    host; a ``.cpu()`` there waits for that work only, while the main
    thread records the previous chunk or prepares the next. ``result()``
    joins, folds each machine's queue counters once, drops the inert
    padding rows and returns the :class:`FleetMultiEpochResult`."""

    def __init__(self, fleet: "FleetManager", future):
        self._fleet = fleet
        self._future = future
        self._result: Optional[FleetMultiEpochResult] = None

    def result(self, timeout: Optional[float] = None) -> FleetMultiEpochResult:
        """Join the dispatch. On expiry of ``timeout`` (seconds) a
        :class:`DispatchError` is raised and the dispatch keeps running."""
        if self._result is None:
            try:
                _fstate, (stats, flags, plans) = self._future.result(timeout)
            except concurrent.futures.TimeoutError:
                raise DispatchError(f"fleet dispatch did not complete within {timeout}s") from None
            except concurrent.futures.CancelledError:
                raise
            except BaseException as e:
                raise DispatchError(f"fleet dispatch failed: {e!r}") from e
            K = len(self._fleet.machines)
            stats, flags, plans = _map(lambda a: a[:K], (stats, flags, plans))
            if stats.queue is not None:
                for i, m in enumerate(self._fleet.machines):
                    m._fold_queue_stats(_index_tree(stats.queue, i))
            self._result = FleetMultiEpochResult(stats=stats, plans=plans, flags=flags.numpy())
        return self._result


class FleetManager:
    """K :class:`CentralManager` machines advancing as one batched tick.

    Control-plane operations (register/allocate/free/telemetry/bandwidth)
    address the machines directly (``fleet.machines[m]``); whatever state
    they change is uploaded on the next dispatch. ``run_epochs`` is the data
    plane: stack -> one vmapped loop over the epochs -> park each machine's
    slice -> one telemetry copy.

    Machines must agree on every shape (num_pages, max_tenants,
    queue_size, exact_sampling) and on their device, and carry no page
    pool; the knobs may differ. Plan buffers take the fleet-wide largest
    budget; a machine's lists are its own, padded with -1.

    ``devices`` (:func:`resolve_devices`): ``None`` or ``1`` runs one slice
    on the machines' device; an int n splits over ``cuda:0`` ..
    ``cuda:n-1``; a sequence of devices splits over those, one contiguous
    slice of machines each (the module docstring says when a mixed list is
    bit-equal). ``pad_to`` (default: the device count) pads K up to a
    multiple with inert machines (no tenants, no backlog) whose rows every
    result drops; the padded count must divide over the devices.

    Dirty tracking: after a dispatch each machine's state is a lazy slice
    of its device slice's stack. Only machines whose control plane fired
    since (a state setter or a pending ``OwnerSegments`` rebuild) are
    uploaded, into their rows of their slice with ``index_copy_``;
    ``upload_stats`` counts them.
    """

    def __init__(
        self,
        machines: Sequence[CentralManager],
        devices=None,
        pad_to: Optional[int] = None,
    ):
        if len(machines) == 0:
            raise ValueError("fleet needs at least one machine")
        self.machines: List[CentralManager] = list(machines)
        first = self.machines[0]
        for m in self.machines:
            for knob in ("num_pages", "max_tenants", "queue_size", "exact_sampling", "device"):
                if getattr(m, knob) != getattr(first, knob):
                    raise ValueError(f"fleet machines must share {knob}")
            if m.pool is not None:
                raise ValueError(
                    "pool-backed data planes are per-machine host objects; run them on a "
                    "single CentralManager"
                )
        self.device = first.device
        self.devices = resolve_devices(devices, self.device)
        self.num_pages = first.num_pages
        self.max_tenants = first.max_tenants
        self.queue_size = first.queue_size
        self.exact_sampling = first.exact_sampling
        self.plan_size = max(m.plan_size for m in self.machines)
        self.num_shards = len(self.devices)
        K = len(self.machines)
        multiple = self.num_shards if pad_to is None else int(pad_to)
        if multiple < 1:
            raise ValueError("pad_to must be >= 1")
        self.num_padded = K + (-K) % multiple
        if self.num_padded % self.num_shards:
            raise ValueError(
                f"padded machine count {self.num_padded} must divide over {self.num_shards} "
                "devices (pad_to must be a multiple of the device count)"
            )
        per = self.num_padded // self.num_shards
        # dirty tracking: each slice's cached stack and each machine's params
        # object as of its last upload; each row's generator (None: inert or
        # down)
        self._slices = [_Slice(d, s * per, (s + 1) * per) for s, d in enumerate(self.devices)]
        self._written_params: List[object] = [None] * K
        self._rngs: List[Optional[torch.Generator]] = [None] * K
        self._inert_state: Optional[PolicyState] = None
        # one dispatch thread, so batched ticks run in order while the main
        # thread keeps the host side of a sweep busy
        self._worker: Optional[_DispatchWorker] = None
        self._inflight = None
        self._inflight_k = 0
        self._inflight_rng_states: List[Tuple[torch.Generator, torch.Tensor]] = []
        # the first worker exception, noted when it happens; every later
        # fleet operation raises it until recover_dispatch
        self._dispatch_error: Optional[BaseException] = None
        # failed machines: slot -> the real state parked at failure
        self._parked: Dict[int, PolicyState] = {}
        self.heartbeat = None
        # chaos hooks (tests): fail the next n dispatches / delay each one
        self._chaos_fail_n = 0
        self._chaos_delay_s = 0.0
        self.upload_stats = {
            "dispatches": 0,
            "clean_dispatches": 0,
            "restacked_machines": 0,
            "seg_rebuilds": 0,
        }
        # host seconds: stacking and uploads, drawing the deviates, launching
        # the batched tick, and the telemetry copy (which waits for it)
        self.phase_seconds = {"assemble": 0.0, "draw": 0.0, "tick": 0.0, "transfer": 0.0}
        # the dispatch thread's seconds per slice: its tick, then its copy
        self.slice_seconds = [0.0] * self.num_shards

    @property
    def num_machines(self) -> int:
        return len(self.machines)

    def __len__(self) -> int:
        return len(self.machines)

    # ------------------------------------------------------------ stacking
    def _machine_dirty(self, m: CentralManager) -> bool:
        return m._mutated or m._segs_owner is not None

    def _make_inert_state(self) -> PolicyState:
        """A machine that computes but matters to nobody: no tenants, no
        backlog, the same shapes as every real machine."""
        if self._inert_state is None:
            state = PolicyState.create(
                self.num_pages, self.max_tenants, seed=0, queue_size=self.queue_size,
                device=self.device,
            )
            self._inert_state = state._replace(rng=None, segs=OwnerSegments.build(
                np.full((self.num_pages,), -1, np.int32), self.max_tenants, self.device))
        return self._inert_state

    def _check_dispatch_error(self) -> None:
        if self._dispatch_error is not None:
            raise DispatchError(
                f"fleet dispatch worker failed: {self._dispatch_error!r}"
            ) from self._dispatch_error

    def _join(self) -> None:
        """Adopt the in-flight dispatch's stacked states: the pipeline's sync
        point, which waits for the worker's tick and telemetry copy."""
        self._check_dispatch_error()
        if self._inflight is not None:
            try:
                fstates, _host = self._inflight.result()
            except concurrent.futures.CancelledError:
                raise
            except BaseException as e:
                raise DispatchError(f"fleet dispatch failed: {e!r}") from e
            for sl, f in zip(self._slices, fstates):
                sl.fstate = f
            self._inflight = None

    def _machine_state(self, i: int) -> PolicyState:
        """Machine ``i``'s row of its slice's stack, on the machine's device."""
        self._join()
        sl = self._slices[i // (self.num_padded // self.num_shards)]
        return machine_slice(sl.fstate, i - sl.lo, self._rngs[i], self.device)

    def _row_rng(self, i: int, state: PolicyState):
        return None if i in self._parked else state.rng

    def _assemble(self) -> None:
        """Bring the stacked state and params up to date, uploading only the
        machines whose control plane fired since the last dispatch."""
        self._join()
        t0 = time.perf_counter()
        K = len(self.machines)
        pad = self.num_padded - K
        fresh = self._slices[0].fstate is None
        dirty = [i for i, m in enumerate(self.machines) if fresh or self._machine_dirty(m)]
        for i in dirty:
            if self.machines[i]._segs_owner is not None:
                self.upload_stats["seg_rebuilds"] += 1
            self.machines[i]._ensure_segs()
        if fresh or len(dirty) == K:
            states = [m._state for m in self.machines]
            self._rngs = [self._row_rng(i, s) for i, s in enumerate(states)]
            states += [self._make_inert_state()] * pad
            for sl in self._slices:
                sl.fstate = _to(stack_states(states[sl.lo : sl.hi]), sl.device)
            self.upload_stats["restacked_machines"] += K
        elif dirty:
            for i in dirty:
                self._rngs[i] = self._row_rng(i, self.machines[i]._state)
            for sl in self._slices:
                mine = [i for i in dirty if sl.lo <= i < sl.hi]
                if not mine:
                    continue
                rows = _to(stack_states([self.machines[i]._state for i in mine]), sl.device)
                idx = torch.as_tensor([i - sl.lo for i in mine], dtype=torch.int64,
                                      device=sl.device)
                _map2(lambda F, r: F.index_copy_(0, idx, r), sl.fstate, rows)
            self.upload_stats["restacked_machines"] += len(dirty)
        params_dirty = self._slices[0].fparams is None or any(
            m.params is not self._written_params[i] for i, m in enumerate(self.machines)
        )
        if params_dirty:
            plist = [m.params for m in self.machines] + [self.machines[0].params] * pad
            for sl in self._slices:
                sl.fparams = stack_params(plist[sl.lo : sl.hi], sl.device)
        if not dirty and not params_dirty:
            self.upload_stats["clean_dispatches"] += 1
        self.phase_seconds["assemble"] += time.perf_counter() - t0

    def _park_slices(self) -> None:
        """Point every machine's state at its lazy slice of the advanced
        stack; nothing materialises, and the in-flight dispatch is not even
        joined, until a control-plane or telemetry path reads a machine."""

        def slicer(i: int) -> Callable[[], PolicyState]:
            return lambda: self._machine_state(i)

        for i, m in enumerate(self.machines):
            m._set_fleet_state(slicer(i))
            self._written_params[i] = m.params

    def _deviates(self, k: int) -> Optional[torch.Tensor]:
        """[K', k, P] sampling deviates: each live machine's drawn from its
        own generator in machine order, zeros for inert and down rows."""
        if self.exact_sampling:
            return None
        t0 = time.perf_counter()
        P = self.num_pages
        zero = torch.zeros((k, P), dtype=torch.float32, device=self.device)
        rows = [
            zero if g is None else policy.clt_deviates(g, k, P, self.device)
            for g in self._rngs
        ]
        z = torch.stack(rows + [zero] * (self.num_padded - len(rows)))
        self.phase_seconds["draw"] += time.perf_counter() - t0
        return z

    # ------------------------------------------------------------ dispatch
    def run_epochs_async(
        self,
        k: int,
        counts: Optional[np.ndarray] = None,
        collect_plans: bool = False,
        trim_stats: bool = False,
        inline: bool = False,
    ) -> FleetPendingResult:
        """Dispatch ``k`` epochs for every machine and return at once.

        The handle's ``result()`` brings the telemetry; meanwhile the host
        may record the previous chunk, prepare the next or fire
        control-plane events (``scenario.run_sweep`` pipelines on this).
        ``inline=True`` runs the same work on the calling thread and returns
        a resolved handle: the serialised fallback of a sweep whose worker
        misbehaved."""
        self._check_dispatch_error()
        K = len(self.machines)
        pad = self.num_padded - K
        self._assemble()
        cn = None
        if counts is not None:
            cn = np.asarray(counts)
            if cn.ndim not in (2, 3) or cn.shape[0] != K:
                raise ValueError(f"counts must be [K, P] or [K, k, P] with K={K}, got {cn.shape}")
            if pad:
                cn = np.concatenate([cn, np.zeros((pad,) + cn.shape[1:], cn.dtype)], axis=0)
        rng_states = [(g, g.get_state()) for g in self._rngs if g is not None]
        z = self._deviates(k)
        kw = dict(
            k=k, max_tenants=self.max_tenants, plan_size=self.plan_size,
            exact_sampling=self.exact_sampling, collect_plans=collect_plans,
            trim_stats=trim_stats,
        )
        # the card slices first: their ticks are queued on the card before
        # the CPU slices' ticks take the thread
        order = sorted(range(self.num_shards), key=lambda s: self.devices[s].type != "cuda")
        slices = [dataclasses.replace(sl) for sl in self._slices]
        hb = self.heartbeat
        chaos_fail = self._chaos_fail_n > 0
        if chaos_fail:
            self._chaos_fail_n -= 1
        chaos_delay = self._chaos_delay_s
        seconds, slice_seconds = self.phase_seconds, self.slice_seconds

        def work():
            if hb is not None:
                hb.beat(0)
            if chaos_delay:
                time.sleep(chaos_delay)
            if chaos_fail:
                raise RuntimeError("injected dispatch failure (chaos hook)")
            t0 = time.perf_counter()
            c = None if cn is None else cn.astype(np.uint32, copy=False).astype(np.int64)
            outs = [None] * len(slices)
            for s in order:
                sl = slices[s]
                t = time.perf_counter()
                outs[s] = fleet_multi_epoch(
                    sl.fstate, sl.fparams,
                    None if c is None else torch.as_tensor(c[sl.lo : sl.hi], device=sl.device),
                    z=None if z is None else z[sl.lo : sl.hi].to(sl.device), **kw,
                )
                slice_seconds[s] += time.perf_counter() - t
            t1 = time.perf_counter()
            host = [None] * len(slices)
            for s in order:
                t = time.perf_counter()
                _fstate, plans, stats, flagged = outs[s]
                host[s] = _map(lambda a: a.cpu(), (stats, flagged, plans))
                slice_seconds[s] += time.perf_counter() - t
            host = _cat(host)
            seconds["tick"] += t1 - t0
            seconds["transfer"] += time.perf_counter() - t1
            if hb is not None:
                hb.beat(0)
            return [o[0] for o in outs], host

        if inline:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            try:
                fut.set_result(work())
            except BaseException:
                self._restore_rngs(rng_states)  # the state before the call stands
                raise
            self._inflight = fut
        else:
            if self._worker is None:
                self._worker = _DispatchWorker()
            self._inflight = self._worker.submit(work)
            self._inflight.add_done_callback(self._note_dispatch_outcome)
        self._inflight_k = k
        self._inflight_rng_states = rng_states
        self._park_slices()
        for m in self.machines:
            m.epoch_index += k
            m._snap = None
        self.upload_stats["dispatches"] += 1
        return FleetPendingResult(self, self._inflight)

    @staticmethod
    def _restore_rngs(rng_states) -> None:
        for g, st in rng_states:
            g.set_state(st)

    def _note_dispatch_outcome(self, fut) -> None:
        """Done-callback on the worker's future: note the first failure when
        it happens, so the main thread learns of it at its next fleet call."""
        if fut.cancelled() or getattr(fut, "_fleet_abandoned", False):
            return
        exc = fut.exception()
        if exc is not None and self._dispatch_error is None:
            self._dispatch_error = exc

    def recover_dispatch(self) -> None:
        """Reset after a failed or wedged dispatch so the chunk can run
        again: drop the in-flight future, clear the noted error, roll the
        epoch clocks back by the dispatched k, put every generator back to
        its state before the dispatch's draw, and abandon the worker (a
        fresh one starts on the next dispatch). The stack is still the one
        the dispatch started from. A supervised fleet gets a fresh
        heartbeat tracker (the old one latched the worker dead)."""
        if self._inflight is not None:
            # flag before cancelling: an abandoned future that resolves later
            # must not re-arm the error cleared here
            self._inflight._fleet_abandoned = True
            self._inflight.cancel()
            self._inflight = None
            for m in self.machines:
                m.epoch_index -= self._inflight_k
                m._snap = None
            self._restore_rngs(self._inflight_rng_states)
            # the parked lazy slices read _join(); with the future dropped
            # they resolve to the rows the dispatch started from
        self._inflight_k = 0
        self._inflight_rng_states = []
        self._dispatch_error = None
        if self._worker is not None:
            self._worker.close(timeout=0.0)  # abandon, never block on a wedge
            self._worker = None
        if self.heartbeat is not None:
            self.enable_supervision(timeout=self.heartbeat.timeout, clock=self.heartbeat.clock)

    # ---------------------------------------------------------- supervision
    def enable_supervision(self, timeout: float = 60.0, clock=None) -> None:
        """Watch the dispatch worker with a ``HeartbeatTracker`` (host 0 is
        the worker; it beats when a dispatch starts and when it ends).
        ``check_worker()`` returning a non-empty list means the worker was
        silent for longer than ``timeout``. ``clock`` is injectable."""
        from repro_torch.runtime.fault_tolerance import HeartbeatTracker

        kw = {} if clock is None else {"clock": clock}
        self.heartbeat = HeartbeatTracker([0], timeout=timeout, **kw)

    def check_worker(self) -> List[int]:
        """Newly dead host ids ([] when healthy or unsupervised)."""
        if self.heartbeat is None:
            return []
        return self.heartbeat.check()

    # --------------------------------------------------------- machine faults
    @property
    def failed_machines(self) -> List[int]:
        return sorted(self._parked)

    def fail_machine(self, i: int) -> None:
        """Drop machine ``i`` (the ``MachineFail`` scenario event): its real
        state, generator included, is parked and the machine runs as an
        inert row of the same shapes. Its epoch clock keeps advancing: the
        down window is real elapsed time."""
        if i in self._parked:
            raise ValueError(f"machine {i} is already failed")
        m = self.machines[i]
        m._ensure_segs()  # park a self-consistent state
        self._parked[i] = m._state
        m._state = self._make_inert_state()
        m._snap = None

    def recover_machine(self, i: int) -> None:
        """Restore machine ``i``'s parked state (``MachineRecover``); the
        setter marks its row dirty, so the next dispatch uploads it."""
        if i not in self._parked:
            raise ValueError(f"machine {i} is not failed")
        m = self.machines[i]
        m._state = self._parked.pop(i)
        m._snap = None

    def run_epochs(
        self,
        k: int,
        counts: Optional[np.ndarray] = None,
        collect_plans: bool = False,
        trim_stats: bool = False,
    ) -> FleetMultiEpochResult:
        """Advance every machine by ``k`` epochs and wait for the telemetry.
        ``counts``: None, [K, P] or [K, k, P]. Each machine's telemetry
        equals ``CentralManager.run_epochs`` on it alone."""
        return self.run_epochs_async(
            k, counts=counts, collect_plans=collect_plans, trim_stats=trim_stats,
        ).result()

    # ----------------------------------------------------------- telemetry
    def live_bytes(self) -> int:
        """Bytes of the stacked state in the reference's packed layout,
        padding rows and each row's 8-byte PRNG key included."""
        self._assemble()
        return (sum(state_nbytes(sl.fstate) for sl in self._slices)
                + _REF_RNG_BYTES * self.num_padded)

    def stacked_placement(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tier[K, P], owner[K, P]) of every machine in one copy per leaf,
        seeding each manager's snapshot cache; per-machine snapshots when a
        machine changed since the last dispatch (its row is stale)."""
        K = len(self.machines)
        self._join()
        clean = self._slices[0].fstate is not None and not any(
            m._mutated for m in self.machines)
        if clean:
            tier = _cat([sl.fstate.pages.tier.cpu() for sl in self._slices])[:K].numpy()
            owner = _cat([sl.fstate.pages.owner.cpu() for sl in self._slices])[:K].numpy()
            for i, m in enumerate(self.machines):
                m._snap = {"tier": tier[i], "owner": owner[i]}
            return tier, owner
        tier = np.stack([m.tiers() for m in self.machines])
        owner = np.stack([m.owners() for m in self.machines])
        return tier, owner
