"""The port's policy autotuner (``repro_torch.launch.hillclimb``) against the
JAX package's, on the CPU.

All inputs come from seeds. Tolerance: exact everywhere (floats compared
with ``==``, float32 knobs by value after rounding both sides to float32),
unless a test says otherwise.

* The candidate functions, the evolution and winner rules, scoring and the
  scenario families are bit-equal with the reference's.
* A whole search is bit-equal with the reference's ``PolicyAutotuner``
  when both packages count accesses exactly: ``SEARCH_SPACE``'s
  ``sample_period`` pinned to 1, and each module's ``run_sweep`` wrapped
  with 4 KiB pages and 40 us epochs (``tests/test_torch_sweep.py``'s
  seams), so pages move under exact counts.
* The reference's ``tests/test_autotune.py`` on the port, sampled (the
  port's generator is not the reference's key): reproducibility, resume,
  the profile store, the sweep-point knobs, the recovery metric, the online
  tuner.
* The online burst: the live manager's state, queue, segments and
  generator come out unchanged, and every clone starts from the live
  generator's state.
* ``policy.policy_epoch`` / ``policy.apply_plan`` against the reference's
  over several epochs.
"""
from __future__ import annotations

import dataclasses
import filecmp
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.tuned as jtuned
import repro.core.policy as jpolicy
import repro.core.simulator as jsim
import repro.core.types as jtypes
import repro.launch.hillclimb as jh
import repro.runtime.fault_tolerance as jft
import repro_torch.configs.tuned as ttuned
import repro_torch.core.policy as tpolicy
import repro_torch.core.simulator as tsim
import repro_torch.core.types as ttypes
import repro_torch.launch.families as tfam
import repro_torch.launch.hillclimb as th
from benchmarks import dynamic_workload as dw
from repro_torch.core.manager import CentralManager
from repro_torch.core.scenario import ScenarioSweep, SkewChange, SweepPoint, run_sweep
from repro_torch.core.simulator import OPTANE, ColocationSim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
GEOMS = [(4096, 16), (65536, 96)]
SEEDS = [0, 7, 123]


def _geom(mod, n_pages, n_epochs, family="skewshift"):
    return mod.family_geometry(family, n_pages=n_pages, n_epochs=n_epochs)


def _f32(x) -> float:
    return float(np.float32(x))


def _params_equal(got, want):
    """Port params (Python scalars) == reference params (jnp leaves), every
    field, float knobs compared after float32 rounding."""
    assert got._fields == tuple(want._fields)
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "fair_mode":
            assert isinstance(g, bool) and g == bool(w), f
        elif f in ("ewma_lambda", "hysteresis", "promote_band", "demote_band"):
            assert isinstance(g, float) and g == _f32(w), f
        else:
            assert isinstance(g, int) and g == int(w), f


# ------------------------------------------------------- candidate functions
def test_search_space_and_weights_equal():
    assert th.SEARCH_SPACE == jh.SEARCH_SPACE
    assert th.P99_WEIGHT == jh.P99_WEIGHT
    assert th.default_candidate() == jh.default_candidate()
    assert th.FAMILIES == jh.FAMILIES


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_mutate_crossover_bit_equal(seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(6):
        a_j, a_t = jh.sample_candidate(rj), th.sample_candidate(rt)
        b_j, b_t = jh.sample_candidate(rj), th.sample_candidate(rt)
        assert a_t == a_j and b_t == b_j
        c_j, c_t = jh.crossover(a_j, b_j, rj), th.crossover(a_t, b_t, rt)
        assert c_t == c_j
        m_j, m_t = jh.mutate(c_j, rj), th.mutate(c_t, rt)
        assert m_t == m_j
    assert rj.random() == rt.random()  # the streams advanced alike


@pytest.mark.parametrize("n_pages,n_epochs", GEOMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_resolve_knobs_bit_equal(seed, n_pages, n_epochs):
    gj, gt = _geom(jh, n_pages, n_epochs), _geom(th, n_pages, n_epochs)
    rng = np.random.default_rng(seed)
    cands = [jh.default_candidate()] + [jh.sample_candidate(rng) for _ in range(8)]
    # the clamps: every knob at and past both ends of its range
    cands.append({k: s["lo"] * 0.5 for k, s in jh.SEARCH_SPACE.items()})
    cands.append({k: s["hi"] * 2.0 for k, s in jh.SEARCH_SPACE.items()})
    for c in cands:
        got, want = th.resolve_knobs(c, gt), jh.resolve_knobs(c, gj)
        assert got == want
        assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in want.items()}


def _tuners(n_pages, n_epochs, **kw):
    base = dict(population=6, generations=2, elites=2, seed=3)
    base.update(kw)
    j = jh.PolicyAutotuner("skewshift", _geom(jh, n_pages, n_epochs), **base)
    t = th.PolicyAutotuner("skewshift", _geom(th, n_pages, n_epochs), device=CPU, **base)
    return j, t


def _synthetic_trajectory(seed, population, generations):
    """A seeded trajectory with ties and candidates on both sides of the
    default's measures."""
    rng = np.random.default_rng(seed)
    traj = []
    for g in range(generations):
        cands = [jh.sample_candidate(rng) for _ in range(population)]
        agg = (1e8 * (1 + rng.choice([-0.1, 0.0, 0.05, 0.2], population))).tolist()
        p99 = (3e-7 * (1 + rng.choice([-0.1, 0.0, 0.1], population))).tolist()
        if g == 0:
            cands[0] = jh.default_candidate()
            agg[0], p99[0] = 1e8, 3e-7
        scores = [jh.scalarize(a, p, 1e8, 3e-7) for a, p in zip(agg, p99)]
        traj.append({"generation": g, "candidates": cands, "agg": agg, "ls_p99": p99,
                     "scores": scores, "best_index": int(np.argmax(scores))})
    return traj, {"agg": 1e8, "ls_p99": 3e-7}


@pytest.mark.parametrize("n_pages,n_epochs", GEOMS)
@pytest.mark.parametrize("seed", SEEDS)
def test_evolve_and_pick_winner_bit_equal(seed, n_pages, n_epochs):
    j, t = _tuners(n_pages, n_epochs)
    traj, ref = _synthetic_trajectory(seed, 6, 3)
    for rec in traj:
        got = t._evolve(rec["candidates"], rec["scores"], np.random.default_rng([seed, 1]))
        want = j._evolve(rec["candidates"], rec["scores"], np.random.default_rng([seed, 1]))
        assert got == want
    assert t._pick_winner(traj, ref) == j._pick_winner(traj, ref)
    assert t.window == j.window and t.ls_names == j.ls_names


@pytest.mark.parametrize("seed", SEEDS)
def test_scalarize_and_measure_history_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        a, p, ra, rp = rng.random(4) * [1e8, 1e-6, 1e8, 1e-6]
        w = float(rng.choice([0.0, 1.0, 4.0]))
        assert th.scalarize(a, p, ra, rp, w) == jh.scalarize(a, p, ra, rp, w)
    assert th.scalarize(1.0, 1.0, 0.0, 0.0) == jh.scalarize(1.0, 1.0, 0.0, 0.0)
    names = ["kvs", "gapbs", "gups"]
    hist = [SimpleNamespace(throughput={n: float(rng.random() * 1e7) for n in names},
                            p99={n: float(rng.random() * 1e-6) for n in names[:2]})
            for _ in range(16)]
    for window in [(0, 16), (4, 16), (3, 9), (16, 16)]:
        for ls in (["kvs"], ["kvs", "gapbs", "gups"], []):
            assert th.measure_history(hist, window, ls) == jh.measure_history(hist, window, ls)


# ------------------------------------------------------ families, geometry
def _scenario_text(sc):
    return (sc.name, sc.n_epochs, sc.description, repr(sc.events))


@pytest.mark.parametrize("n_pages,n_epochs", GEOMS)
@pytest.mark.parametrize("family", jh.FAMILIES)
def test_family_geometry_and_scenario_equal(family, n_pages, n_epochs):
    gj = jh.family_geometry(family, n_pages=n_pages, n_epochs=n_epochs)
    gt = th.family_geometry(family, n_pages=n_pages, n_epochs=n_epochs)
    assert dataclasses.asdict(gt) == dataclasses.asdict(gj)
    assert _scenario_text(th.family_scenario(family, gt)) == \
        _scenario_text(jh.family_scenario(family, gj))
    assert th.ls_tenants(th.family_scenario(family, gt)) == \
        jh.ls_tenants(jh.family_scenario(family, gj))


@pytest.mark.parametrize("smoke", [True, False])
def test_family_geometry_defaults_equal(smoke):
    for family in jh.FAMILIES:
        assert dataclasses.asdict(th.family_geometry(family, smoke=smoke)) == \
            dataclasses.asdict(jh.family_geometry(family, smoke=smoke))


@pytest.mark.parametrize("n_pages,n_epochs", GEOMS)
def test_family_builders_equal(n_pages, n_epochs):
    for name in ("colocation_scenario", "thrash_scenario", "faults_scenario",
                 "sweep_scenario"):
        assert _scenario_text(getattr(tfam, name)(n_pages, n_epochs)) == \
            _scenario_text(getattr(dw, name)(n_pages, n_epochs)), name
    for shift in (None, 3):
        assert _scenario_text(th.skewshift_scenario(n_pages, n_epochs, shift)) == \
            _scenario_text(jh.skewshift_scenario(n_pages, n_epochs, shift))
    for machines in (1, 4, 16):
        assert repr(tfam.sweep_points(machines, n_pages // 64)) == \
            repr(dw.sweep_points(machines, n_pages // 64))


def test_unknown_family_raises():
    with pytest.raises(KeyError, match="unknown scenario family"):
        th.family_scenario("nope", th.family_geometry("thrash", smoke=True))


# --------------------------------------------- a whole search, bit-equal
def _exact_seams(monkeypatch, mod, sim_mod, moved):
    """Pin sample_period to 1 and run every sweep at 4 KiB pages and 40 us
    epochs (exact counts that stay inside the heat bins); ``moved``
    collects each sweep's pages migrated per machine."""
    space = dict(mod.SEARCH_SPACE)
    space["sample_period"] = dict(kind="int", lo=1, hi=1, log=True, default=1)
    monkeypatch.setattr(mod, "SEARCH_SPACE", space)
    orig = mod.run_sweep

    def wrapped(sweep, **kw):
        res = orig(sweep, machine=dataclasses.replace(sim_mod.OPTANE, page_bytes=4096),
                   epoch_seconds=4e-5, **kw)
        moved.append([sum(r.migrated_pages for r in v.history) for v in res.results.values()])
        return res

    monkeypatch.setattr(mod, "run_sweep", wrapped)


def test_exact_search_bit_equal_with_reference(monkeypatch):
    """skewshift at 1,024 pages x 12 epochs, fast 128, policy_chunk 4,
    population 4, generations 2, seed 7: trajectory and winner equal, floats
    exact."""
    moved_j, moved_t = [], []
    _exact_seams(monkeypatch, jh, jsim, moved_j)
    _exact_seams(monkeypatch, th, tsim, moved_t)
    g = dict(n_pages=1024, n_epochs=12, fast=128, policy_chunk=4)
    kw = dict(population=4, generations=2, seed=7)
    want = jh.PolicyAutotuner("skewshift", jh.TunerGeometry(**g), **kw).search()
    got = th.PolicyAutotuner("skewshift", th.TunerGeometry(**g), device=CPU, **kw).search()
    assert not got.interrupted and not want.interrupted
    for rg, rw in zip(got.trajectory, want.trajectory, strict=True):
        for key in ("generation", "candidates", "agg", "ls_p99", "scores", "best_index"):
            assert rg[key] == rw[key], key
    assert got.winner == want.winner
    assert got.ref == want.ref
    assert moved_t == moved_j
    assert max(max(m) for m in moved_t) > 0, "no candidate migrated a page"


# ------------------------------------ the reference's test_autotune.py on the port
GEOM = th.TunerGeometry(n_pages=512, n_epochs=12, fast=64, policy_chunk=4)


def _tuner(**kw):
    base = dict(population=4, generations=2, elites=1, seed=7, device=CPU)
    base.update(kw)
    return th.PolicyAutotuner("skewshift", GEOM, **base)


def _strip(traj):
    return [{k: t[k] for k in ("generation", "candidates", "agg", "ls_p99", "scores")}
            for t in traj]


def test_same_seed_same_trajectory_and_winner():
    r1 = _tuner().search()
    r2 = _tuner().search()
    assert not r1.interrupted and not r2.interrupted
    assert _strip(r1.trajectory) == _strip(r2.trajectory)
    assert r1.winner == r2.winner
    assert r1.ref == r2.ref
    assert r1.winner["agg"] >= r1.ref["agg"] * (1 - 1e-9)
    assert r1.winner["ls_p99"] <= r1.ref["ls_p99"] * (1 + 1e-9)


def test_different_seed_different_population():
    r1 = _tuner(seed=7).search()
    r2 = _tuner(seed=8).search()
    assert r1.trajectory[0]["candidates"][0] == r2.trajectory[0]["candidates"][0]
    assert r1.trajectory[0]["candidates"][1:] != r2.trajectory[0]["candidates"][1:]


def test_kill_resume_reproduces_uninterrupted_run(tmp_path):
    ref = _tuner().search()
    out = str(tmp_path / "tuner")
    partial = _tuner(out_dir=out, checkpoint_every=4).search(stop_after=5)
    assert partial.interrupted and partial.winner is None
    assert os.path.isdir(os.path.join(out, "gen000"))
    resumed = _tuner(out_dir=out, checkpoint_every=4).search(resume=True)
    assert not resumed.interrupted
    assert _strip(resumed.trajectory) == _strip(ref.trajectory)
    assert resumed.winner == ref.winner


def test_resume_state_mismatch_rejected(tmp_path):
    out = str(tmp_path / "tuner")
    _tuner(out_dir=out, generations=1).search()
    with pytest.raises(ValueError, match="seed"):
        _tuner(out_dir=out, seed=8).search(resume=True)


def test_profiles_committed():
    assert {"colocation_4k", "thrash_4k", "skewshift_4k",
            "storm_64k"} <= set(ttuned.profile_names())


def test_profile_jsons_byte_equal_to_reference():
    assert ttuned.profile_names() == jtuned.profile_names()
    assert os.path.realpath(ttuned.profiles_dir()) != os.path.realpath(jtuned.profiles_dir())
    for name in ttuned.profile_names():
        assert filecmp.cmp(ttuned.profile_path(name), jtuned.profile_path(name), shallow=False)


@pytest.mark.parametrize("name", ttuned.profile_names())
def test_profile_roundtrip_one_epoch(name):
    prof = ttuned.load_profile(name)
    params = ttypes.PolicyParams.from_profile(name)
    for f in ttypes.PolicyParams._fields:
        want = prof["params"][f]
        got = getattr(params, f)
        if f == "fair_mode":
            assert got is bool(want)
        else:
            assert float(got) == float(want), f
    mgr = CentralManager(**ttuned.manager_kwargs(name), device=CPU)
    for f in ("migration_budget", "sample_period", "ewma_lambda", "hysteresis", "num_bins",
              "alloc_headroom", "promote_band", "demote_band", "promote_admission",
              "demote_cooldown"):
        assert float(getattr(mgr.params, f)) == float(prof["params"][f]), f
    h = mgr.register(t_miss=0.5)
    mgr.allocate(h, min(64, prof["geometry"]["n_pages"] // 4))
    mgr.run_epoch()
    m = prof["metrics"]
    assert m["tuned"]["agg_throughput"] >= m["default"]["agg_throughput"] * (1 - 1e-9)
    assert m["tuned"]["ls_p99_us"] <= m["default"]["ls_p99_us"] * (1 + 1e-9)


@pytest.mark.parametrize("name", ttuned.profile_names())
def test_params_from_profile_equals_reference(name):
    _params_equal(ttuned.params_from_profile(name), jtuned.params_from_profile(name))
    _params_equal(ttuned.params_from_profile(name, sample_period=77, ewma_lambda=0.3),
                  jtuned.params_from_profile(name, sample_period=77, ewma_lambda=0.3))
    assert ttuned.manager_kwargs(name) == jtuned.manager_kwargs(name)


def test_profile_loader_errors():
    with pytest.raises(KeyError, match="no tuned profile"):
        ttuned.load_profile("no_such_profile")
    with pytest.raises(TypeError, match="unknown PolicyParams"):
        ttuned.params_from_profile(ttuned.profile_names()[0], not_a_field=1)
    with pytest.raises(ValueError, match="exactly PolicyParams._fields"):
        ttuned.save_profile({"name": "x", "family": "y", "geometry": {}, "params": {"a": 1}})


def test_profile_override():
    p = ttuned.params_from_profile(ttuned.profile_names()[0], sample_period=77)
    assert p.sample_period == 77


def test_commit_profile_round_trips(monkeypatch, tmp_path):
    """commit_profile writes into the (redirected) port directory only and
    loads back to the winner's manager params."""
    monkeypatch.setattr(ttuned, "_DIR", str(tmp_path))
    tuner = _tuner(population=3, generations=1)
    res = tuner.search()
    path = tuner.commit_profile(res, name="unit_0k")
    assert os.path.dirname(path) == str(tmp_path)
    assert ttuned.profile_names() == ["unit_0k"]
    prof = ttuned.load_profile("unit_0k")
    with open(path) as f:
        assert json.load(f) == prof
    kw = res.winner["resolved"]
    mgr = CentralManager(num_pages=GEOM.n_pages, fast_capacity=GEOM.fast,
                         migration_budget=kw["migration_budget"], max_tenants=GEOM.max_tenants,
                         num_bins=kw["num_bins"], sample_period=kw["sample_period"],
                         ewma_lambda=kw["ewma_lambda"], hysteresis=kw["hysteresis"],
                         alloc_headroom=kw["alloc_headroom"], device=CPU)
    assert ttypes.PolicyParams.from_profile("unit_0k") == mgr.params
    assert prof["metrics"]["tuned"]["agg_throughput"] == res.winner["agg"]
    assert prof["search"]["scored_window"] == list(tuner.window)
    assert prof["geometry"]["n_pages"] == GEOM.n_pages


def test_manager_hysteresis_kwarg():
    mgr = CentralManager(num_pages=256, fast_capacity=64, migration_budget=8, hysteresis=0.19,
                         device=CPU)
    assert mgr.params.hysteresis == _f32(0.19)


def test_sweep_point_policy_knobs_take_effect():
    scenario = th.skewshift_scenario(512, 8)
    points = (
        SweepPoint("default", seed=0),
        SweepPoint("tuned", seed=0, ewma_lambda=0.9, hysteresis=0.0,
                   num_bins=9, sample_period=31, alloc_headroom=8),
    )
    res = run_sweep(ScenarioSweep(scenario=scenario, points=points), num_pages=512,
                    fast_capacity=64, migration_budget=8, max_tenants=8, policy_chunk=4,
                    device=CPU)
    hist_d = res.results["default"].history
    hist_t = res.results["tuned"].history
    assert len(hist_d) == len(hist_t) == 8
    assert [sum(r.throughput.values()) for r in hist_d] != \
        [sum(r.throughput.values()) for r in hist_t]


def _hist(values, tenant="kvs"):
    return [SimpleNamespace(throughput={tenant: v}) for v in values]


@pytest.mark.parametrize("values,want", [
    ([100, 100, 100, 100, 100, 100, 40, 60, 100, 100], 4),  # dip, then recover
    ([100.0] * 10, 0),  # no dip is instant
    ([100, 100, 100, 100, 100, 10, 10, 10], 4),  # never recovers
])
def test_recovery_epochs(values, want):
    epochs, base = th.recovery_epochs(_hist(values), 4, tenant="kvs")
    assert epochs == want and base == pytest.approx(100.0)
    assert (epochs, base) == jh.recovery_epochs(_hist(values), 4, tenant="kvs")


# ------------------------------------------------------------------- online
def _online_sim(n_pages=512, fast=64, queue_size=0, seed=3):
    mgr = CentralManager(num_pages=n_pages, fast_capacity=fast, migration_budget=fast // 2,
                         max_tenants=8, queue_size=queue_size, device=CPU)
    mgr.params = mgr.params._replace(migration_budget=8)
    return ColocationSim(mgr, OPTANE, seed=seed, policy_chunk=2)


def test_online_retune_no_host_rng_perturbation():
    sim = _online_sim()
    scenario = th.skewshift_scenario(512, 6, shift_epoch=3)
    tuner = th.OnlineTuner(sim, seed=0, triggers=(SkewChange,), device=CPU)
    res = sim.run_scenario(scenario, on_event=tuner.on_event)
    assert len(res.history) == 6
    assert len(tuner.retunes) == 1  # two same-epoch SkewChanges coalesce
    assert tuner.retunes[0]["trigger"].startswith("kvs")
    ref = _online_sim().run_scenario(th.skewshift_scenario(512, 6, shift_epoch=3))
    for a, b in zip(ref.history[:3], res.history[:3]):
        assert a.throughput == b.throughput


def test_online_swap_is_in_plan_budget():
    sim = _online_sim()
    tuner = th.OnlineTuner(sim, seed=0, device=CPU)
    sim.run_scenario(th.skewshift_scenario(512, 4, shift_epoch=2), on_event=tuner.on_event)
    assert tuner.retunes, "Arrive/SkewChange triggers must have fired"
    plan = sim.backend.plan_size
    for r in tuner.retunes:
        assert 1 <= r["budget"] <= plan
    sim.run_epoch()


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("profile", ["thrash_4k", "skewshift_64k"])
def test_candidate_params_equal_reference(profile, seed):
    """Every knob the online tuner perturbs, at a profile's live params:
    the port's candidates equal the reference's (floats as float32)."""
    knobs = ("migration_budget", "sample_period", "ewma_lambda", "hysteresis",
             "alloc_headroom")

    def stub(params):
        return SimpleNamespace(backend=SimpleNamespace(params=params, plan_size=300))

    jt = jh.OnlineTuner(stub(jtuned.params_from_profile(profile)), knobs=knobs, candidates=10)
    tt = th.OnlineTuner(stub(ttuned.params_from_profile(profile)), knobs=knobs, candidates=10,
                        device=CPU)
    got = tt._candidate_params(np.random.default_rng([seed, 23, 0]))
    want = jt._candidate_params(np.random.default_rng([seed, 23, 0]))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        _params_equal(g, w)


def _burst_sim():
    """A live queue-mode machine after a few epochs of skewshift."""
    sim = _online_sim(queue_size=32, seed=4)
    sim.run_scenario(th.skewshift_scenario(512, 4, shift_epoch=2))
    return sim


def _live_snapshot(mgr):
    st = ttypes.state_to_numpy(mgr._state)
    leaves = {}

    def walk(node, prefix):
        for name, v in node._asdict().items():
            if v is None:
                continue
            if hasattr(v, "_asdict"):
                walk(v, f"{prefix}{name}.")
            else:
                leaves[prefix + name] = np.asarray(v).tobytes()

    walk(st, "")
    return dict(
        leaves=leaves,
        rng=mgr._state.rng.get_state().clone(),
        queue=mgr.queue_counters(),
        segs_host=[np.asarray(a).copy() for a in mgr._segs_host],
        epoch_index=mgr.epoch_index,
    )


def test_burst_leaves_live_manager_unchanged():
    sim = _burst_sim()
    mgr = sim.backend
    mgr._ensure_segs()
    before = _live_snapshot(mgr)
    sim_rng = sim.rng.bit_generator.state
    params = mgr.params
    tuner = th.OnlineTuner(sim, seed=1, device=CPU)
    cands = tuner._candidate_params(np.random.default_rng(0))
    best, scores, measures = tuner._burst(cands, np.random.default_rng(1))
    after = _live_snapshot(mgr)
    assert after["leaves"] == before["leaves"]
    assert torch.equal(after["rng"], before["rng"])
    assert after["queue"] == before["queue"]
    assert all(np.array_equal(a, b) for a, b in zip(after["segs_host"], before["segs_host"]))
    assert after["epoch_index"] == before["epoch_index"]
    assert sim.rng.bit_generator.state == sim_rng
    assert mgr.params is params
    assert len(scores) == len(cands) and np.isfinite(scores).all()


def test_burst_clones_start_from_the_live_generator():
    sim = _burst_sim()
    live = sim.backend._state.rng
    tuner = th.OnlineTuner(sim, seed=1, device=CPU)
    clones = tuner._clones(tuner._candidate_params(np.random.default_rng(0)))
    gens = [c._state.rng for c in clones]
    assert len({id(g) for g in gens} | {id(live)}) == len(gens) + 1
    for g in gens:
        assert torch.equal(g.get_state(), live.get_state())
    # one clone drawing leaves the others and the live generator where they were
    torch.rand(8, generator=gens[0])
    assert torch.equal(gens[1].get_state(), live.get_state())
    # same params on every clone: the same deviates, so the same measures
    cur = sim.backend.params
    _best, scores, measures = tuner._burst([cur, cur, cur], np.random.default_rng(2))
    assert measures[0] == measures[1] == measures[2]


def test_retune_live_manager_changes_only_params():
    sim = _burst_sim()
    mgr = sim.backend
    mgr._ensure_segs()
    before = _live_snapshot(mgr)
    tuner = th.OnlineTuner(sim, seed=0, device=CPU)
    tuner.retune()
    assert _live_snapshot(mgr)["leaves"] == before["leaves"]
    assert torch.equal(mgr._state.rng.get_state(), before["rng"])
    r = tuner.retunes[0]
    assert r["budget"] == mgr.params.migration_budget


# --------------------------------------------------------------------- docs
def test_params_md_documents_every_field():
    with open(os.path.join(REPO, "docs", "PARAMS.md")) as f:
        text = f.read()
    for field in ttypes.PolicyParams._fields:
        assert f"`{field}`" in text, field


def test_search_space_only_tunes_documented_params():
    assert set(th.SEARCH_SPACE) <= set(ttypes.PolicyParams._fields)
    for k, s in th.SEARCH_SPACE.items():
        assert s["lo"] <= s["default"] <= s["hi"], k


# ------------------------------------------------- policy_epoch / apply_plan
def _policy_inputs(seed, P, T, F, R):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, T, P)
    tier = np.where(np.arange(P) < F, 1, 0)
    t_miss = np.array([0.1, 0.5, 1.0, 0.3][:T], np.float32)
    jp = jtypes.PageState.create(P)._replace(owner=jnp.asarray(owner, jnp.int32),
                                              tier=jnp.asarray(tier, jnp.int8))
    jt = jtypes.TenantState.create(T)._replace(active=jnp.ones((T,), bool),
                                                t_miss=jnp.asarray(t_miss),
                                                arrival=jnp.arange(T, dtype=jnp.int32))
    jparams = jtypes.PolicyParams(fast_capacity=jnp.int32(F), migration_budget=jnp.int32(R),
                                  sample_period=jnp.int32(1))
    tp = ttypes.PageState.create(P, CPU)._replace(owner=torch.as_tensor(owner, dtype=torch.int16),
                                                   tier=torch.as_tensor(tier, dtype=torch.int8))
    tt = ttypes.TenantState.create(T, CPU)._replace(
        active=torch.ones(T, dtype=torch.bool), t_miss=torch.as_tensor(t_miss),
        arrival=torch.arange(T, dtype=torch.int32))
    tparams = ttypes.PolicyParams(fast_capacity=F, migration_budget=R, sample_period=1)
    return rng, (jp, jt, jparams), (tp, tt, tparams)


def _tree_equal(got, want, path):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f"{path}.{f}"
            continue
        g = g.numpy()
        w = np.asarray(w)
        if w.dtype.kind == "f":
            assert np.array_equal(g.astype(w.dtype).view(np.int32), w.view(np.int32)), \
                f"{path}.{f}"
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), f"{path}.{f}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_epoch_and_apply_plan_match_reference(seed):
    """tests/test_core_policy.py:164-183's loop (P 64, T 3, F 16, R 32, ten
    epochs of seeded counts) through both packages: pages, tenants, plan and
    stats of every epoch bit-equal; the capacity and rate caps hold."""
    P, T, F, R = 64, 3, 16, 32
    rng, (jp, jt, jparams), (tp, tt, tparams) = _policy_inputs(seed, P, T, F, R)
    for step in range(10):
        sampled = rng.integers(0, 10 if step % 3 else 5000, P).astype(np.uint32)
        jp, jt, jplan, jstats = jpolicy.policy_epoch(
            jp, jt, jnp.asarray(sampled), jparams, max_tenants=T, plan_size=R)
        tp, tt, tplan, tstats = tpolicy.policy_epoch(
            tp, tt, torch.as_tensor(sampled.astype(np.int64)), tparams, max_tenants=T,
            plan_size=R)
        _tree_equal(tp, jp, f"epoch {step} pages")
        _tree_equal(tt, jt, f"epoch {step} tenants")
        _tree_equal(tplan, jplan, f"epoch {step} plan")
        _tree_equal(tstats, jstats, f"epoch {step} stats")
        jp = jpolicy.apply_plan(jp, jplan)
        tp = tpolicy.apply_plan(tp, tplan)
        _tree_equal(tp, jp, f"epoch {step} applied")
        assert int((tp.tier == ttypes.TIER_FAST).sum()) <= F
        assert int(tplan.num_promote) + int(tplan.num_demote) <= R


def test_apply_plan_drops_padding():
    """-1 padding (and ids past the end) are dropped, not wrapped to P-1."""
    P = 16
    pages = ttypes.PageState.create(P, CPU)._replace(
        owner=torch.zeros(P, dtype=torch.int16), tier=torch.zeros(P, dtype=torch.int8))
    plan = ttypes.MigrationPlan(promote=torch.tensor([3, -1, -1, P + 2]),
                                demote=torch.tensor([-1, -1, -1, -1]))
    out = tpolicy.apply_plan(pages, plan)
    want = np.zeros(P, np.int8)
    want[3] = ttypes.TIER_FAST
    assert np.array_equal(out.tier.numpy(), want)
    jpages = jtypes.PageState.create(P)._replace(tier=jnp.zeros(P, jnp.int8))
    jplan = jtypes.MigrationPlan(promote=jnp.asarray([3, -1, -1, P + 2], jnp.int32),
                                 demote=jnp.full((4,), -1, jnp.int32))
    assert np.array_equal(np.asarray(jpolicy.apply_plan(jpages, jplan).tier), want)


def test_params_meta_helpers_equal_reference():
    """The meta encoding the profiles use round-trips the same in both."""
    from repro_torch.runtime.fault_tolerance import _params_from_meta, _params_to_meta

    for name in ttuned.profile_names():
        meta = ttuned.load_profile(name)["params"]
        assert _params_to_meta(_params_from_meta(meta)) == jft._params_to_meta(
            jft._params_from_meta(meta))
