"""Fault tolerance of the fleet's scenario sweeps (``core.scenario.run_sweep``)
and of the trainer (``launch/train.py``).

  * :class:`HeartbeatTracker` declares a host dead after ``timeout`` seconds
    of silence (the fleet's dispatch worker is host 0); the clock is
    injectable, so tests run on fake time.
  * :class:`DispatchSupervisor` bounds every wait on the fleet's dispatch
    worker and, after a fault, degrades the sweep to the serialised inline
    path.
  * :class:`SweepCheckpoint` saves everything a sweep needs to continue bit
    for bit (every machine's state and generator, its knobs, clocks and
    counters, and every simulator's host state and history) in one atomic
    step directory, and restores it in place.

The trainer's half, as the reference's:
  * :class:`StragglerDetector` keeps a step-time EWMA per host and names
    the hosts slower than ``ratio`` x the median;
  * :func:`plan_elastic_mesh` picks the largest rectangular (data, model)
    mesh the surviving hosts allow;
  * :class:`ElasticRunner` drives a step function with checkpoints and, on
    an injected :class:`HostFailure`, restores the last checkpoint and goes
    on with a halved world.

States cross into a sweep checkpoint as numpy arrays in the reference's dtypes
(``types.state_to_numpy`` / ``state_from_numpy``); each machine's
``torch.Generator`` state is saved beside them. The meta is JSON.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import PolicyParams, PolicyState, f32, state_from_numpy, state_to_numpy


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    alive: bool = True


class HeartbeatTracker:
    def __init__(self, host_ids: Sequence[int], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.timeout = timeout
        now = clock()
        self.hosts: Dict[int, HostState] = {
            h: HostState(host_id=h, last_beat=now) for h in host_ids
        }

    def beat(self, host_id: int) -> None:
        self.hosts[host_id].last_beat = self.clock()

    def check(self) -> List[int]:
        """Returns newly dead host ids (death latches)."""
        now = self.clock()
        dead = []
        for h in self.hosts.values():
            if h.alive and now - h.last_beat > self.timeout:
                h.alive = False
                dead.append(h.host_id)
        return dead

    def alive_hosts(self) -> List[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]


class DispatchSupervisor:
    """Supervises a fleet's dispatch worker during a sweep.

    ``join`` bounds every wait on an in-flight chunk by ``timeout`` (None =
    wait forever); a timeout or worker fault surfaces as ``DispatchError``,
    the sweep recovers (``FleetManager.recover_dispatch``), calls
    :meth:`note_fallback` and runs the chunk again through
    :meth:`dispatch`, which from then on runs every chunk inline. With a
    timeout the fleet's heartbeat supervision is on as well."""

    def __init__(self, fleet, timeout: Optional[float] = None):
        self.fleet = fleet
        self.timeout = timeout
        self.degraded = False  # sticky: once fallen back, stay serialised
        self.fallbacks = 0
        if timeout is not None:
            fleet.enable_supervision(timeout=timeout)

    def dispatch(self, k: int, counts=None, trim_stats: bool = True):
        return self.fleet.run_epochs_async(
            k, counts=counts, trim_stats=trim_stats, inline=self.degraded
        )

    def join(self, handle):
        """Bounded wait on a ``FleetPendingResult``; raises DispatchError on
        a timeout or a worker fault."""
        return handle.result(self.timeout)

    def note_fallback(self) -> None:
        self.degraded = True
        self.fallbacks += 1


_BIGINT_KEY = "$bigint"
_PARAM_FLOAT_FIELDS = ("ewma_lambda", "hysteresis", "promote_band", "demote_band")


def _sanitize_meta(obj):
    """Make a meta tree JSON-encodable: numpy scalars and arrays become
    Python values, ints beyond 64 bits (the PCG64 state words are 128-bit)
    tagged strings."""
    if isinstance(obj, dict):
        return {k: _sanitize_meta(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize_meta(v) for v in obj]
    if isinstance(obj, (bool, np.bool_)):
        return bool(obj)
    if isinstance(obj, (int, np.integer)):
        v = int(obj)
        if v > 2**63 - 1 or v < -(2**63):
            return {_BIGINT_KEY: str(v)}
        return v
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return [_sanitize_meta(v) for v in obj.tolist()]
    return obj


def _unsanitize_meta(obj):
    if isinstance(obj, dict):
        if set(obj) == {_BIGINT_KEY}:
            return int(obj[_BIGINT_KEY])
        return {k: _unsanitize_meta(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unsanitize_meta(v) for v in obj]
    return obj


def _params_to_meta(params) -> dict:
    out = {}
    for f, v in params._asdict().items():
        if f == "fair_mode":
            out[f] = bool(v)
        elif f in _PARAM_FLOAT_FIELDS:
            out[f] = float(v)
        else:
            out[f] = int(v)
    return out


def _params_from_meta(meta: dict) -> PolicyParams:
    """The manager's form of the knobs: Python scalars, floats rounded to
    float32."""
    kw = {}
    for f, v in meta.items():
        if f == "fair_mode":
            kw[f] = bool(v)
        elif f in _PARAM_FLOAT_FIELDS:
            kw[f] = f32(v)
        else:
            kw[f] = int(v)
    return PolicyParams(**kw)


def _sim_to_meta(sim) -> dict:
    tenants = []
    for nm, t in sim.tenants.items():
        ent = {
            "name": nm,
            "spec": dataclasses.asdict(t.spec),
            "page_ids": np.asarray(t.page_ids).tolist(),
            "perm": np.asarray(t._perm).tolist(),
        }
        if hasattr(t, "_pp_perms"):
            ent["pp_perms"] = [np.asarray(p).tolist() for p in t._pp_perms]
            ent["pp_side"] = int(t._pp_side)
        tenants.append(ent)
    return {
        "rng": sim.rng.bit_generator.state,
        "stall_epochs": float(sim._stall_epochs),
        "failed": bool(sim.failed),
        "handles": {nm: int(h) for nm, h in sim.handles.items()},
        "tenants": tenants,
        "history": [dataclasses.asdict(r) for r in sim.history],
    }


def _sim_from_meta(sim, meta: dict) -> None:
    from repro_torch.core.simulator import EpochRecord, TenantSim, WorkloadSpec

    sim.rng.bit_generator.state = meta["rng"]
    sim._stall_epochs = float(meta["stall_epochs"])
    sim.failed = bool(meta["failed"])
    sim.handles = {nm: int(h) for nm, h in meta["handles"].items()}
    sim.tenants = {}
    for ent in meta["tenants"]:
        spec_d = dict(ent["spec"])
        spec_d["sets"] = tuple(tuple(s) for s in spec_d.get("sets", ()))
        spec = WorkloadSpec(**spec_d)
        t = TenantSim.__new__(TenantSim)
        t.spec = spec
        t.page_ids = np.asarray(ent["page_ids"], np.int64)
        t.rng = sim.rng
        t._perm = np.asarray(ent["perm"], np.int64)
        t.probs = TenantSim._build_probs(spec, len(t.page_ids))[t._perm]
        if "pp_perms" in ent:
            t._pp_perms = tuple(np.asarray(p, np.int64) for p in ent["pp_perms"])
            t._pp_side = int(ent["pp_side"])
        sim.tenants[ent["name"]] = t
    sim.history = [EpochRecord(**r) for r in meta["history"]]


def _state_arrays(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Every array of a numpy state tree under a dotted name."""
    for name, v in tree._asdict().items():
        if v is None:
            continue
        if hasattr(v, "_asdict"):
            _state_arrays(v, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = np.asarray(v)


def _tree_from_arrays(arrays: Dict[str, np.ndarray], prefix: str) -> SimpleNamespace:
    """The nested namespace ``state_from_numpy`` reads, from dotted names."""
    root: dict = {}
    for key, a in arrays.items():
        if not key.startswith(prefix):
            continue
        node = root
        *path, leaf = key[len(prefix):].split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a

    def ns(d):
        return SimpleNamespace(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    return ns(root)


class _StepStore:
    """Checkpoint steps in a directory: ``step_<n>/`` holds ``arrays.npz``
    and ``meta.json``. A step is written to ``tmp.<n>`` and renamed, so a
    crash mid-save never leaves a broken latest step; the newest ``keep``
    steps stay."""

    _STEP = re.compile(r"^step_(\d+)$")

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = self._STEP.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, arrays: Dict[str, np.ndarray], meta: dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{old:08d}"), ignore_errors=True)

    def restore(self, step: Optional[int] = None) -> Tuple[Dict[str, np.ndarray], dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint step in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return arrays, meta


class SweepCheckpoint:
    """Checkpoint / resume of fleet scenario sweeps (``scenario.run_sweep``).

    One atomic step holds every machine's full policy state (for a failed
    machine the parked real state, so the saved structure never depends on
    which machines are down) with its generator state, and a JSON meta:
    each machine's knobs, epoch clock, arrival counter, queue counters and
    failed flag, and each simulator's numpy PRNG state (PCG64, 128-bit
    words as tagged strings), tenants with their page maps and scatter
    permutations, and recorded history. A sweep killed at any chunk
    boundary and resumed from the latest step replays the rest to the
    histories of an uninterrupted run."""

    def __init__(self, directory: str, keep: int = 3):
        self.store = _StepStore(directory, keep=keep)

    def latest(self) -> Optional[int]:
        return self.store.latest_step()

    def save(self, cur: int, fleet, sims) -> None:
        arrays: Dict[str, np.ndarray] = {}
        machines_meta = []
        for i, m in enumerate(fleet.machines):
            failed = i in fleet._parked
            if failed:
                state = fleet._parked[i]
            else:
                m._ensure_segs()  # checkpoint a self-consistent state
                state = m._state
            _state_arrays(state_to_numpy(state), f"m{i}.", arrays)
            arrays[f"m{i}.rng"] = state.rng.get_state().numpy()
            machines_meta.append({
                "params": _params_to_meta(m.params),
                "epoch_index": int(m.epoch_index),
                "arrival_seq": int(m._arrival_seq),
                "queue": {
                    "enqueued": int(m.queue_enqueued),
                    "drained": int(m.queue_drained),
                    "cancelled": int(m.queue_cancelled),
                    "dropped": int(m.queue_dropped),
                },
                "migration_failures": int(m.migration_failures),
                "failed": failed,
            })
        meta = _sanitize_meta({
            "cur": int(cur),
            "machines": machines_meta,
            "sims": [_sim_to_meta(s) for s in sims],
        })
        self.store.save(int(cur), arrays, meta)

    def restore(self, fleet, sims, step: Optional[int] = None) -> int:
        """Restore the fleet and the simulators in place; returns the
        sweep's epoch cursor."""
        arrays, meta = self.store.restore(step)
        meta = _unsanitize_meta(meta)
        # un-fail whatever is failed now; the checkpoint's flags re-park below
        for i in list(fleet.failed_machines):
            fleet.recover_machine(i)
        for i, m in enumerate(fleet.machines):
            mm = meta["machines"][i]
            tree = _tree_from_arrays(arrays, f"m{i}.")
            tree.rng = np.zeros(2, np.uint32)
            state: PolicyState = state_from_numpy(tree, m.device)
            state.rng.set_state(torch.from_numpy(arrays[f"m{i}.rng"].copy()))
            m._state = state
            m._segs_owner = None  # restored segments are current by construction
            m.params = _params_from_meta(mm["params"])
            m.epoch_index = int(mm["epoch_index"])
            m._arrival_seq = int(mm["arrival_seq"])
            q = mm["queue"]
            m.queue_enqueued = int(q["enqueued"])
            m.queue_drained = int(q["drained"])
            m.queue_cancelled = int(q["cancelled"])
            m.queue_dropped = int(q["dropped"])
            m.migration_failures = int(mm["migration_failures"])
            m._snap = None
        for sim, sm in zip(sims, meta["sims"]):
            _sim_from_meta(sim, sm)
        for i, mm in enumerate(meta["machines"]):
            if mm["failed"]:
                fleet.fail_machine(i)
        return int(meta["cur"])


# ------------------------------------------------------------------ trainer
class StragglerDetector:
    """Per-host step-time EWMA; hosts slower than ``ratio`` x the median are
    stragglers. Mitigations (re-shard its data, backup steps) are the
    caller's: the detector only decides."""

    def __init__(self, host_ids: Sequence[int], ewma: float = 0.3, ratio: float = 1.8):
        self.ewma = ewma
        self.ratio = ratio
        self.times: Dict[int, Optional[float]] = {h: None for h in host_ids}

    def record(self, host_id: int, step_seconds: float) -> None:
        prev = self.times.get(host_id)
        self.times[host_id] = (
            step_seconds if prev is None else self.ewma * step_seconds + (1 - self.ewma) * prev
        )

    def stragglers(self) -> List[int]:
        vals = [t for t in self.times.values() if t is not None]
        if len(vals) < 2:
            return []
        med = sorted(vals)[len(vals) // 2]
        return [h for h, t in self.times.items() if t is not None and t > self.ratio * med]


def plan_elastic_mesh(alive_hosts: int, chips_per_host: int,
                      model_parallel: int) -> Tuple[int, int]:
    """Largest rectangular (data, model) mesh from the surviving hosts: the
    model axis is fixed (the weights are sharded that way), the data axis
    shrinks to the largest power of two of full rows. Returns (data_size,
    model_size)."""
    total = alive_hosts * chips_per_host
    if total < model_parallel:
        raise RuntimeError("not enough chips for the model-parallel axis")
    rows = total // model_parallel
    return 1 << (rows.bit_length() - 1), model_parallel


class HostFailure(RuntimeError):
    pass


class ElasticRunner:
    """Drives a step function with checkpoint / restart on injected failures.

    ``make_step(world_size) -> step_fn`` and ``step_fn(state, step) ->
    state``. At each step in ``fail_at`` the runner loses a host: it halves
    the world, restores the last checkpoint (saved every ``save_every``
    steps) and goes on from its step."""

    def __init__(self, checkpointer, make_step, save_every: int = 10):
        self.ckpt = checkpointer
        self.make_step = make_step
        self.save_every = save_every
        self.restarts = 0

    def run(self, state, world_size: int, n_steps: int, fail_at=()):
        step_fn = self.make_step(world_size)
        fail_at = set(fail_at)
        step = 0
        while step < n_steps:
            if step % self.save_every == 0:
                self.ckpt.save(step, state, meta={"world": world_size}, blocking=True)
            if step in fail_at:
                fail_at.discard(step)
                self.restarts += 1
                world_size = max(world_size // 2, 1)
                step_fn = self.make_step(world_size)
                last = self.ckpt.latest_step()
                state, _ = self.ckpt.restore(state, step=last)
                step = last
                continue
            state = step_fn(state, step)
            step += 1
        return state, world_size
