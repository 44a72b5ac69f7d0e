"""Fleet-driven policy autotuner, on the port's fleet.

A port of the JAX package's ``launch/hillclimb.py``. It searches the
``PolicyParams`` surface (``docs/PARAMS.md`` is the field reference;
``SEARCH_SPACE`` below is the subset the tuner explores) with the fleet as
a parallel evaluator: every generation of candidates becomes one
:class:`~repro_torch.core.scenario.ScenarioSweep` (one machine per
candidate, every machine replaying the same scenario) advanced by
``run_sweep`` in one batched tick per chunk. Every searched knob is a
per-machine leaf of the fleet's stacked params, so a whole population runs
as one fleet.

Two modes:

* **offline** (:class:`PolicyAutotuner`): evolutionary search (elites kept,
  uniform crossover, clamped mutation, seeded ``numpy`` Generators, so the
  trajectory is deterministic) over a scenario family
  (``launch/families.py``, ``skewshift_scenario`` below). Winners are
  committed as named profiles under ``repro_torch/configs/tuned/`` and load
  back through ``PolicyParams.from_profile("thrash_4k")``. The paper-default
  candidate is index 0 of generation 0, and the winner must weakly dominate
  it (aggregate throughput >= default and LS p99 <= default).
* **online** (:class:`OnlineTuner`): a controller attached to a live
  ``ColocationSim`` that watches phase events (Arrive / SkewChange /
  ShiftWorkingSet), evaluates a small burst of candidate params against
  the current policy state and a frozen access distribution through a
  throwaway ``FleetManager``, and hot-swaps the winner into the live
  manager. The burst's clones each get their own generator, set to the
  live manager's generator state, so every candidate sees the same
  deviates and the live stream does not move; the access counts come from
  the tuner's own seeded stream, so attaching the controller never
  perturbs the host run.

The search is resumable: the tuner saves its state after every generation
and forwards ``checkpoint_every`` to each generation's ``run_sweep``, so a
search stopped mid-generation resumes to the uninterrupted trajectory.

Everything runs on ``device`` (``None``: the card; without a GPU that
raises unless ``device="cpu"`` is given).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --scenario thrash --smoke
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --scenario colocation \\
        --smoke --commit-profile
"""
from __future__ import annotations

import argparse
import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.manager import CentralManager, resolve_device
from repro_torch.core.scenario import (
    Arrive,
    Scenario,
    ScenarioSweep,
    ShiftWorkingSet,
    SkewChange,
    SweepPoint,
    adversarial_scenario,
    recovery_epochs,
    run_sweep,
)
from repro_torch.core.simulator import WorkloadSpec
from repro_torch.core.types import f32
from repro_torch.launch import families

# --------------------------------------------------------------- search space
#
# The knobs the offline tuner explores, each a per-machine ``PolicyParams``
# leaf reachable through ``SweepPoint``. ``frac`` knobs are fractions of the
# fast tier and resolve to page counts per geometry; ``log=True`` searches
# and mutates multiplicatively. ``default`` is the paper/engine default.
SEARCH_SPACE: Dict[str, Dict] = {
    "sample_period": dict(kind="int", lo=25, hi=400, log=True, default=100),
    "ewma_lambda": dict(kind="float", lo=0.1, hi=0.9, log=False, default=0.5),
    "hysteresis": dict(kind="float", lo=0.0, hi=0.2, log=False, default=0.08),
    "num_bins": dict(kind="int", lo=4, hi=10, log=False, default=6),
    "migration_budget": dict(
        kind="frac", lo=1 / 64, hi=1 / 4, log=True, default=1 / 8
    ),
    "alloc_headroom": dict(kind="frac", lo=0.0, hi=1 / 8, log=False, default=0.0),
}

P99_WEIGHT = 4.0  # score = tput gain - weight * relative LS-p99 regression


@dataclass(frozen=True)
class TunerGeometry:
    """The shape knobs of one tuning run: fixed per search (they are shapes
    of the fleet's state) and recorded in the committed profile."""

    n_pages: int
    n_epochs: int
    fast: int
    queue_size: int = 0
    max_tenants: int = 8
    policy_chunk: int = 8


# ------------------------------------------------------------- candidates
Candidate = Dict[str, float]  # knob -> value in search units (JSON-stable)


def default_candidate() -> Candidate:
    return {k: float(s["default"]) for k, s in SEARCH_SPACE.items()}


def sample_candidate(rng: np.random.Generator) -> Candidate:
    cand = {}
    for k, s in SEARCH_SPACE.items():
        if s["log"]:
            lo, hi = math.log(max(s["lo"], 1e-9)), math.log(s["hi"])
            cand[k] = float(math.exp(rng.uniform(lo, hi)))
        else:
            cand[k] = float(rng.uniform(s["lo"], s["hi"]))
    return cand


def mutate(cand: Candidate, rng: np.random.Generator, scale: float = 0.25) -> Candidate:
    out = dict(cand)
    for k, s in SEARCH_SPACE.items():
        if rng.random() >= 0.6:  # per-knob mutation probability
            continue
        if s["log"]:
            v = out[k] * math.exp(float(rng.normal(0.0, scale)))
        else:
            v = out[k] + float(rng.normal(0.0, scale * (s["hi"] - s["lo"])))
        out[k] = float(min(max(v, s["lo"]), s["hi"]))
    return out


def crossover(a: Candidate, b: Candidate, rng: np.random.Generator) -> Candidate:
    return {k: float(a[k] if rng.random() < 0.5 else b[k]) for k in SEARCH_SPACE}


def resolve_knobs(cand: Candidate, geom: TunerGeometry) -> Dict[str, object]:
    """Candidate (search units) -> concrete ``SweepPoint`` overrides."""
    kw: Dict[str, object] = {}
    for k, v in cand.items():
        s = SEARCH_SPACE[k]
        if s["kind"] == "frac":
            pages = int(round(v * geom.fast))
            if k == "migration_budget":
                kw[k] = max(2, min(pages, geom.fast))
            else:
                kw[k] = max(0, min(pages, geom.fast // 2))
        elif s["kind"] == "int":
            kw[k] = int(round(min(max(v, s["lo"]), s["hi"])))
        else:
            kw[k] = float(min(max(v, s["lo"]), s["hi"]))
    return kw


# ---------------------------------------------------------------- scoring
def ls_tenants(scenario: Scenario) -> List[str]:
    """Latency-sensitive tenants = Arrive specs with a real FMMR target."""
    return sorted(
        {
            ev.spec.name
            for ev in scenario.events
            if isinstance(ev, Arrive) and ev.spec.t_miss < 1.0
        }
    )


def measure_history(
    history: Sequence, window: Tuple[int, int], ls_names: Sequence[str]
) -> Tuple[float, float]:
    """(mean aggregate ops/s, mean LS p99 seconds) over ``window`` epochs."""
    recs = list(history[window[0] : window[1]])
    if not recs:
        return 0.0, 0.0
    agg = float(np.mean([sum(r.throughput.values()) for r in recs]))
    vals = [r.p99[nm] for r in recs for nm in ls_names if nm in r.p99]
    return agg, float(np.mean(vals)) if vals else 0.0


def scalarize(
    agg: float, ls_p99: float, ref_agg: float, ref_p99: float,
    p99_weight: float = P99_WEIGHT,
) -> float:
    """Throughput gain over the reference minus a one-sided p99 penalty:
    p99 improvements are not rewarded (meet the target, spend the rest on
    aggregate throughput)."""
    gain = agg / max(ref_agg, 1e-12)
    pen = max(0.0, ls_p99 / max(ref_p99, 1e-12) - 1.0)
    return float(gain - p99_weight * pen)


# ``recovery_epochs`` (the online tuner's responsiveness metric) lives in
# ``core/scenario.py`` and is re-exported here, as in the reference.
assert recovery_epochs is not None


# ------------------------------------------------------- scenario families
def skewshift_scenario(n_pages: int, n_epochs: int, shift_epoch: Optional[int] = None) -> Scenario:
    """Two LS tenants + one BE; mid-run the KVS tenant's accesses jump to a
    previously cold scatter (``SkewChange`` set 0 -> set 1). The learned
    heat map is stale at once and the recovery slope is governed by the
    migration budget and the sampling rate: the probe the online tuner is
    scored on (epochs to recover, :func:`recovery_epochs`)."""
    kvs = (3 * n_pages) // 8
    gap = n_pages // 4
    shift = n_epochs // 2 if shift_epoch is None else shift_epoch
    return Scenario(
        name=f"skewshift_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            Arrive(0, WorkloadSpec(
                "kvs", kvs, t_miss=0.2, threads=4,
                sets=((0.18, 0.9), (0.18, 0.0)), value_bytes=16384,
            )),
            Arrive(0, WorkloadSpec(
                "gapbs", gap, t_miss=0.4, threads=8, sets=((0.2, 0.85),),
            )),
            Arrive(0, WorkloadSpec("gups", n_pages // 4, threads=6)),
            SkewChange(shift, "kvs", 0, 0.0),
            SkewChange(shift, "kvs", 1, 0.9),
        ),
        description="hot-set jump responsiveness probe (online autotuner)",
    )


# family -> needs the bounded data plane (queue-mode shapes)
FAMILY_BOUNDED = {"thrash": True, "adversarial": True}
FAMILY_MAX_TENANTS = {"sweep": 16}
FAMILIES = ("colocation", "thrash", "skewshift", "faults", "sweep", "adversarial")


def family_geometry(
    family: str,
    *,
    smoke: bool = False,
    n_pages: Optional[int] = None,
    n_epochs: Optional[int] = None,
) -> TunerGeometry:
    """The geometry conventions of ``benchmarks/dynamic_workload.py``: fast
    tier = P/8, default budget = fast/8. The queue (for a bounded family)
    is sized for the largest budget in the search range: it is a shape, so
    it is fixed across candidates."""
    if n_pages is None:
        n_pages = 4096 if smoke else 65536
    if n_epochs is None:
        n_epochs = 16 if smoke else 96
    fast = n_pages // 8
    return TunerGeometry(
        n_pages=n_pages,
        n_epochs=n_epochs,
        fast=fast,
        queue_size=fast // 2 if FAMILY_BOUNDED.get(family, False) else 0,
        max_tenants=FAMILY_MAX_TENANTS.get(family, 8),
        policy_chunk=4 if smoke else 8,
    )


def family_scenario(family: str, geom: TunerGeometry) -> Scenario:
    if family == "skewshift":
        return skewshift_scenario(geom.n_pages, geom.n_epochs)
    if family == "adversarial":
        # the composite storm: boundary straddle phase-locked with a
        # ping-pong flipper
        return adversarial_scenario(geom.n_pages, geom.n_epochs, fast_capacity=geom.fast)
    makers = {
        "colocation": families.colocation_scenario,
        "thrash": families.thrash_scenario,
        "faults": families.faults_scenario,
        "sweep": families.sweep_scenario,
    }
    if family not in makers:
        raise KeyError(f"unknown scenario family {family!r}; choose from {FAMILIES}")
    return makers[family](geom.n_pages, geom.n_epochs)


def scale_tag(n_pages: int) -> str:
    return f"{n_pages // 1024}k"


# ---------------------------------------------------------------- offline
@dataclass
class TunerResult:
    family: str
    interrupted: bool
    winner: Optional[Dict]  # {candidate, resolved, agg, ls_p99, score, generation, index}
    ref: Optional[Dict]  # default-candidate measures {agg, ls_p99}
    trajectory: List[Dict] = field(default_factory=list)


class PolicyAutotuner:
    """Offline population search over ``SEARCH_SPACE`` with the fleet as
    the evaluator (one sweep point per candidate, one batched tick per
    chunk) on ``device``.

    Candidate 0 of generation 0 is always the paper-default configuration;
    its measures are the reference for scoring and for the weak-domination
    winner rule. The simulators and the search are seeded, so the same
    ``seed`` reproduces the trajectory bit for bit.
    """

    def __init__(
        self,
        family: str,
        geom: TunerGeometry,
        scenario: Optional[Scenario] = None,
        *,
        population: int = 8,
        generations: int = 4,
        elites: int = 2,
        seed: int = 0,
        eval_seed: int = 0,
        p99_weight: float = P99_WEIGHT,
        out_dir: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        devices=None,
        device=None,
        pipeline: bool = True,
        verbose: bool = False,
    ):
        assert population >= 2 and generations >= 1 and 1 <= elites < population
        self.device = resolve_device(device, "PolicyAutotuner")
        self.family = family
        self.geom = geom
        self.scenario = scenario if scenario is not None else family_scenario(family, geom)
        self.population = population
        self.generations = generations
        self.elites = elites
        self.seed = seed
        self.eval_seed = eval_seed
        self.p99_weight = p99_weight
        self.out_dir = out_dir
        self.checkpoint_every = checkpoint_every
        self.devices = devices
        self.pipeline = pipeline
        self.verbose = verbose
        # the steady window: skip the opening quarter (arrivals and the
        # first convergence) and score the rest
        self.window = (geom.n_epochs // 4, geom.n_epochs)
        self.ls_names = ls_tenants(self.scenario)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)

    # ------------------------------------------------------------ state io
    def _state_path(self) -> Optional[str]:
        return None if self.out_dir is None else os.path.join(self.out_dir, "tuner_state.json")

    def _save_state(self, next_gen: int, population, trajectory, ref) -> None:
        path = self._state_path()
        if path is None:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "family": self.family,
                    "seed": self.seed,
                    "next_generation": next_gen,
                    "population": population,
                    "trajectory": trajectory,
                    "ref": ref,
                },
                f,
            )
        os.replace(tmp, path)

    def _load_state(self) -> Optional[Dict]:
        path = self._state_path()
        if path is None or not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        if state["family"] != self.family or state["seed"] != self.seed:
            raise ValueError(
                f"tuner state at {path} is for family={state['family']!r} "
                f"seed={state['seed']}; this run is {self.family!r}/{self.seed}"
            )
        return state

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[hillclimb:{self.family}] {msg}", flush=True)

    # ---------------------------------------------------------- evaluation
    def _evaluate(self, gen, population, *, resume=False, stop_after=None):
        """One generation = one ScenarioSweep. Returns [(agg, ls_p99)] per
        candidate, or None if the sweep stopped at a checkpoint early."""
        geom = self.geom
        points = tuple(
            SweepPoint(name=f"c{i:02d}", seed=self.eval_seed, **resolve_knobs(c, geom))
            for i, c in enumerate(population)
        )
        sweep = ScenarioSweep(scenario=self.scenario, points=points)
        ckpt_kw: Dict[str, object] = {}
        if self.out_dir is not None and self.checkpoint_every is not None:
            gen_dir = os.path.join(self.out_dir, f"gen{gen:03d}")
            os.makedirs(gen_dir, exist_ok=True)
            ckpt_kw = dict(
                checkpoint_every=self.checkpoint_every,
                checkpoint_dir=gen_dir,
                resume=resume,
                stop_after=stop_after,
            )
        res = run_sweep(
            sweep,
            num_pages=geom.n_pages,
            fast_capacity=geom.fast,
            migration_budget=resolve_knobs(default_candidate(), geom)["migration_budget"],
            max_tenants=geom.max_tenants,
            queue_size=geom.queue_size,
            policy_chunk=geom.policy_chunk,
            devices=self.devices,
            device=self.device,
            pipeline=self.pipeline,
            **ckpt_kw,
        )
        if any(len(r.history) < geom.n_epochs for r in res.results.values()):
            return None  # stopped at a checkpoint boundary before the end
        return [
            measure_history(res.results[p.name].history, self.window, self.ls_names)
            for p in points
        ]

    # ----------------------------------------------------------- evolution
    def _evolve(self, population, scores, rng: np.random.Generator):
        order = sorted(range(len(population)), key=lambda i: (-scores[i], i))
        keep = [dict(population[i]) for i in order[: self.elites]]
        parents = order[: max(2, len(order) // 2)]  # top half breeds
        children = []
        while len(keep) + len(children) < self.population:
            pa = population[parents[int(rng.integers(len(parents)))]]
            pb = population[parents[int(rng.integers(len(parents)))]]
            children.append(mutate(crossover(pa, pb, rng), rng))
        return keep + children

    def _pick_winner(self, trajectory, ref) -> Dict:
        """Best-scoring candidate that weakly dominates the default (ties
        resolve to the earliest generation/index, so the default itself is
        the floor)."""
        best = None
        for rec in trajectory:
            for i, cand in enumerate(rec["candidates"]):
                agg, p99 = rec["agg"][i], rec["ls_p99"][i]
                if agg < ref["agg"] * (1 - 1e-9) or p99 > ref["ls_p99"] * (1 + 1e-9):
                    continue
                entry = {
                    "candidate": dict(cand),
                    "resolved": resolve_knobs(cand, self.geom),
                    "agg": agg,
                    "ls_p99": p99,
                    "score": rec["scores"][i],
                    "generation": rec["generation"],
                    "index": i,
                }
                if best is None or entry["score"] > best["score"] + 1e-12:
                    best = entry
        assert best is not None, "default candidate must qualify as winner floor"
        return best

    # -------------------------------------------------------------- search
    def search(self, *, resume: bool = False, stop_after: Optional[int] = None) -> TunerResult:
        """Run (or resume) the population search.

        ``stop_after`` forwards to each generation's ``run_sweep`` as the
        kill-simulation hook: the sweep returns a partial result at the
        first checkpoint past that epoch and the tuner stops with
        ``interrupted=True``; ``search(resume=True)`` continues to the
        uninterrupted trajectory."""
        state = self._load_state() if resume else None
        gen0, trajectory, ref, population = 0, [], None, None
        if state is not None:
            gen0 = state["next_generation"]
            population = [dict(c) for c in state["population"]]
            trajectory = state["trajectory"]
            ref = state["ref"]
        if population is None:
            rng0 = np.random.default_rng([self.seed, 0])
            population = [default_candidate()] + [
                sample_candidate(rng0) for _ in range(self.population - 1)
            ]
        for gen in range(gen0, self.generations):
            measures = self._evaluate(
                gen, population, resume=resume and gen == gen0, stop_after=stop_after
            )
            if measures is None:
                self._log(f"gen {gen}: stopped early (stop_after={stop_after})")
                return TunerResult(self.family, True, None, ref, trajectory)
            if ref is None:  # candidate 0 of generation 0 is the default
                ref = {"agg": measures[0][0], "ls_p99": measures[0][1]}
            scores = [
                scalarize(a, p, ref["agg"], ref["ls_p99"], self.p99_weight)
                for a, p in measures
            ]
            trajectory.append(
                {
                    "generation": gen,
                    "candidates": [dict(c) for c in population],
                    "agg": [a for a, _ in measures],
                    "ls_p99": [p for _, p in measures],
                    "scores": scores,
                    "best_index": int(np.argmax(scores)),
                }
            )
            self._log(
                f"gen {gen}: best score {max(scores):.4f} "
                f"(agg {measures[int(np.argmax(scores))][0]:,.0f} ops/s)"
            )
            # a generator per generation: resuming at generation g draws the
            # same stream without saving generator state
            rng = np.random.default_rng([self.seed, 1, gen])
            population = self._evolve(population, scores, rng)
            self._save_state(gen + 1, population, trajectory, ref)
        winner = self._pick_winner(trajectory, ref)
        self._log(
            f"winner: gen {winner['generation']} c{winner['index']:02d} "
            f"{winner['resolved']} (+{100 * (winner['agg'] / ref['agg'] - 1):.1f}% agg)"
        )
        return TunerResult(self.family, False, winner, ref, trajectory)

    # -------------------------------------------------------------- commit
    def commit_profile(self, result: TunerResult, name: Optional[str] = None) -> str:
        """Write the winner as a named profile under the port's
        ``configs/tuned/``."""
        from repro_torch.configs.tuned import save_profile
        from repro_torch.runtime.fault_tolerance import _params_to_meta

        assert not result.interrupted and result.winner is not None
        geom, w = self.geom, result.winner
        kw = w["resolved"]
        mgr = CentralManager(
            num_pages=geom.n_pages,
            fast_capacity=geom.fast,
            migration_budget=kw["migration_budget"],
            max_tenants=geom.max_tenants,
            num_bins=kw["num_bins"],
            sample_period=kw["sample_period"],
            ewma_lambda=kw["ewma_lambda"],
            hysteresis=kw["hysteresis"],
            alloc_headroom=kw["alloc_headroom"],
            queue_size=geom.queue_size,
            device=self.device,
        )
        prof = {
            "name": name or f"{self.family}_{scale_tag(geom.n_pages)}",
            "family": self.family,
            "geometry": {
                "n_pages": geom.n_pages,
                "n_epochs": geom.n_epochs,
                "fast_capacity": geom.fast,
                "queue_size": geom.queue_size,
                "max_tenants": geom.max_tenants,
                "policy_chunk": geom.policy_chunk,
            },
            "params": _params_to_meta(mgr.params),
            "metrics": {
                "default": {
                    "agg_throughput": result.ref["agg"],
                    "ls_p99_us": result.ref["ls_p99"] * 1e6,
                },
                "tuned": {
                    "agg_throughput": w["agg"],
                    "ls_p99_us": w["ls_p99"] * 1e6,
                },
            },
            "search": {
                "seed": self.seed,
                "eval_seed": self.eval_seed,
                "generations": self.generations,
                "population": self.population,
                "score": w["score"],
                "scored_window": list(self.window),
                "generation": w["generation"],
                "index": w["index"],
            },
        }
        return save_profile(prof)


# ----------------------------------------------------------------- online
def fork_generator(gen: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A new generator on ``gen``'s device in ``gen``'s state; ``gen`` is
    not advanced by drawing from the copy."""
    if gen is None:
        return None
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


class OnlineTuner:
    """Mid-run re-tuner: on a phase event, evaluate a small burst of
    candidate params against the current policy state and frozen access
    distribution, then hot-swap the winner into the live manager.

    The burst builds K throwaway ``CentralManager`` shells on ``device``
    (one per candidate), each holding the live manager's state with a fork
    of its generator (``fork_generator``), and advances them
    ``burst_epochs`` through one ``FleetManager`` dispatch with access
    counts drawn from the tuner's own seeded stream (the live sim's stream
    is swapped out and restored). The live manager's state, queue,
    segments and generator come out of a burst unchanged; only the params
    swap changes it. Scoring mirrors the simulator's chunk record: per-epoch
    tenant FMMR -> closed-loop latency fixed point -> aggregate throughput,
    charged with each candidate's own migration traffic, with the offline
    tuner's one-sided LS-p99 penalty plus a QoS-deficit term (mean excess
    of measured LS FMMR over its target). The deficit term dominates
    (default weight 10: meet LS targets first, spend the rest on
    throughput), because during recovery both other terms mislead.
    Candidate 0 is "keep the current params", so a swap only happens on a
    strict improvement.

    The manager's ``plan_size`` caps how far ``migration_budget`` can be
    tuned up at run time: construct the live manager with the budget
    headroom the controller should have. ``device`` (``None``: the card)
    must be the live manager's.
    """

    TRIGGERS = (Arrive, SkewChange, ShiftWorkingSet)

    def __init__(
        self,
        sim,
        *,
        knobs: Tuple[str, ...] = ("migration_budget", "sample_period", "ewma_lambda"),
        candidates: int = 6,
        burst_epochs: int = 8,
        seed: int = 0,
        p99_weight: float = P99_WEIGHT,
        qos_weight: float = 10.0,
        triggers: Optional[Tuple[type, ...]] = None,
        device=None,
    ):
        assert candidates >= 2 and burst_epochs >= 2
        self.device = resolve_device(device, "OnlineTuner")
        self.sim = sim
        if triggers is not None:
            self.TRIGGERS = tuple(triggers)
        self.knobs = knobs
        self.candidates = candidates
        self.burst_epochs = burst_epochs
        self.seed = seed
        self.p99_weight = p99_weight
        self.qos_weight = qos_weight
        self.retunes: List[Dict] = []

    # `run_scenario(..., on_event=tuner.on_event)` wiring
    def on_event(self, sim, ev) -> None:
        if isinstance(ev, self.TRIGGERS) and sim is self.sim and sim.tenants:
            self.retune(trigger=ev.label())

    def _perturb(self, cur, rng: np.random.Generator):
        plan = self.sim.backend.plan_size
        rep = {}
        for k in self.knobs:
            if k == "migration_budget":
                v = int(round(int(cur.migration_budget) * math.exp(rng.normal(0.0, 0.7))))
                rep[k] = min(max(v, 1), plan)
            elif k == "sample_period":
                v = int(round(int(cur.sample_period) * math.exp(rng.normal(0.0, 0.5))))
                rep[k] = min(max(v, 5), 2000)
            elif k == "ewma_lambda":
                rep[k] = f32(min(max(float(cur.ewma_lambda) + rng.normal(0.0, 0.15), 0.05), 0.95))
            elif k == "hysteresis":
                rep[k] = f32(min(max(float(cur.hysteresis) + rng.normal(0.0, 0.05), 0.0), 0.3))
            elif k == "alloc_headroom":
                v = int(round(int(cur.alloc_headroom) + rng.normal(0.0, plan / 4)))
                rep[k] = min(max(v, 0), int(cur.fast_capacity) // 2)
            else:
                raise KeyError(f"online tuner cannot perturb {k!r}")
        return cur._replace(**rep)

    def _candidate_params(self, rng: np.random.Generator):
        cur = self.sim.backend.params
        plan = self.sim.backend.plan_size
        out = [cur]
        # the deterministic recovery play: the whole plan buffer as budget
        # and faster sampling, the aggressive config a phase change wants
        out.append(
            cur._replace(
                migration_budget=int(plan),
                sample_period=max(10, int(cur.sample_period) // 2),
            )
        )
        while len(out) < self.candidates:
            out.append(self._perturb(cur, rng))
        return out

    def _clones(self, cands):
        """One throwaway manager per candidate over the live state, each
        with its own fork of the live generator."""
        mgr = self.sim.backend
        if mgr.device != self.device:
            raise ValueError(
                f"the live manager runs on {mgr.device}, the tuner on {self.device}"
            )
        mgr._ensure_segs()  # the clones share the segs-complete state
        state = mgr._state
        clones = []
        for p in cands:
            c = CentralManager(
                num_pages=mgr.num_pages,
                fast_capacity=int(mgr.params.fast_capacity),
                migration_budget=mgr.plan_size,
                max_tenants=mgr.max_tenants,
                queue_size=mgr.queue_size,
                device=self.device,
            )
            c._state = state._replace(rng=fork_generator(state.rng))
            c._segs_owner = None  # do not rebuild segs from the empty owner
            c.params = p
            c.epoch_index = mgr.epoch_index
            clones.append(c)
        return clones

    def _burst(self, cands, rng: np.random.Generator):
        from repro_torch.core.fleet import FleetManager

        sim, mgr = self.sim, self.sim.backend
        clones = self._clones(cands)
        arrays = sim._arrays()
        names, M, page_mask, threads, bpo = arrays
        tier = np.asarray(mgr.tiers())
        saved_rng = sim.rng  # burst draws must not advance the host stream
        sim.rng = rng
        try:
            counts, _ctx = sim._chunk_prepare(arrays, tier)
        finally:
            sim.rng = saved_rng
        fleet = FleetManager(clones, devices=1)
        # inline: the burst waits for its result, so it needs no dispatch
        # thread; the result's leaves come to the host in one copy each
        res = fleet.run_epochs_async(
            self.burst_epochs, counts=np.tile(counts, (len(cands), 1)), trim_stats=True,
            inline=True,
        ).result()

        handles = [sim.handles[nm] for nm in names]
        fmmr = res.stats.fmmr_now.numpy()[:, :, handles]  # [K, k, n]
        moved = (
            res.stats.promoted.numpy() + res.stats.demoted.numpy()
        ).sum(axis=-1)  # [K, k] selection traffic (commit upper bound)
        m = sim.machine
        fast_op = m.fast.latency_ns * 1e-9 + bpo / (m.fast.bandwidth_GBps * 1e9)
        ls = [i for i, nm in enumerate(names) if sim.tenants[nm].spec.t_miss < 1.0]
        targets = np.array([sim.tenants[names[i]].spec.t_miss for i in ls], float)
        # terminal-state scoring: where will this candidate have taken the
        # machine by the end of the horizon; scoring the transient would
        # charge the migration investment against the candidates that make it
        start = self.burst_epochs - 1
        measures = []
        for ki in range(len(cands)):
            aggs, p99s, deficits = [], [], []
            for e in range(start, self.burst_epochs):
                miss = fmmr[ki, e]
                lat, slow_op = sim._latencies(
                    miss, float(moved[ki, e]) * m.page_bytes, threads, bpo
                )
                aggs.append((threads / lat).sum())
                if ls:
                    p99s.append(
                        np.mean(
                            [
                                sim._mixture_quantile(0.99, miss[i], fast_op[i], slow_op[i])
                                for i in ls
                            ]
                        )
                    )
                    deficits.append(np.maximum(miss[ls] - targets, 0.0).mean())
            measures.append(
                (
                    float(np.mean(aggs)),
                    float(np.mean(p99s)) if p99s else 0.0,
                    float(np.mean(deficits)) if deficits else 0.0,
                )
            )
        ref_agg, ref_p99 = measures[0][0], measures[0][1]
        scores = [
            scalarize(a, p, ref_agg, ref_p99, self.p99_weight) - self.qos_weight * d
            for a, p, d in measures
        ]
        return int(np.argmax(scores)), scores, measures  # ties keep current

    def retune(self, trigger: str = "manual"):
        """Run one tuning burst now; hot-swap on strict improvement.
        Returns the params left installed on the live manager."""
        sim = self.sim
        if self.retunes and self.retunes[-1]["epoch"] == len(sim.history):
            return sim.backend.params  # coalesce same-epoch event storms
        rng = np.random.default_rng([self.seed, 23, len(self.retunes)])
        cands = self._candidate_params(rng)
        best, scores, measures = self._burst(cands, rng)
        if best != 0:
            sim.backend.params = cands[best]  # per-machine knobs: no rebuild
        self.retunes.append(
            {
                "epoch": len(sim.history),
                "trigger": trigger,
                "chosen": best,
                "scores": scores,
                "measures": measures,
                "budget": int(sim.backend.params.migration_budget),
                "sample_period": int(sim.backend.params.sample_period),
            }
        )
        return sim.backend.params


# -------------------------------------------------------------------- CLI
def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Fleet-driven policy autotuner")
    ap.add_argument("--scenario", default="thrash", choices=FAMILIES,
                    help="scenario family to tune")
    ap.add_argument("--smoke", action="store_true", help="toy geometry (~seconds)")
    ap.add_argument("--pages", type=int, default=None, help="override page count")
    ap.add_argument("--epochs", type=int, default=None, help="override epoch count")
    ap.add_argument("--population", type=int, default=8)
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--elites", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="state + sweep checkpoints here (enables --resume)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="epochs between sweep checkpoints inside a generation")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="kill-simulation: stop the current generation at the "
                         "first checkpoint past this epoch")
    ap.add_argument("--commit-profile", action="store_true",
                    help="write the winner under src/repro_torch/configs/tuned/")
    ap.add_argument("--profile-name", default=None)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    geom = family_geometry(
        args.scenario, smoke=args.smoke, n_pages=args.pages, n_epochs=args.epochs
    )
    tuner = PolicyAutotuner(
        args.scenario,
        geom,
        population=args.population,
        generations=args.generations,
        elites=args.elites,
        seed=args.seed,
        out_dir=args.out_dir,
        checkpoint_every=args.checkpoint_every,
        devices=args.devices,
        device=args.device,
        verbose=True,
    )
    result = tuner.search(resume=args.resume, stop_after=args.stop_after)
    if result.interrupted:
        print("search interrupted at a checkpoint; rerun with --resume")
        return 2
    w, ref = result.winner, result.ref
    print(f"\nscenario family : {args.scenario} ({geom.n_pages} pages x {geom.n_epochs} epochs)")
    print(f"device          : {tuner.device}")
    print(f"default         : agg {ref['agg']:,.0f} ops/s  LS p99 {ref['ls_p99'] * 1e6:.1f} us")
    print(f"tuned           : agg {w['agg']:,.0f} ops/s  LS p99 {w['ls_p99'] * 1e6:.1f} us")
    print(f"delta           : {100 * (w['agg'] / max(ref['agg'], 1e-12) - 1):+.2f}% agg, "
          f"{100 * (w['ls_p99'] / max(ref['ls_p99'], 1e-12) - 1):+.2f}% p99")
    print(f"winning knobs   : {w['resolved']}")
    if args.commit_profile:
        path = tuner.commit_profile(result, name=args.profile_name)
        print(f"profile written : {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
