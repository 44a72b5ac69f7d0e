"""Fault tolerance of the port's fleet sweep: the fleet-sweep cases of
``tests/test_chaos.py`` run on ``repro_torch``.

* checkpoint / resume: a sweep killed at every chunk boundary, and one
  killed while a machine is down, resume to the histories of an
  uninterrupted run (sampled: each machine's generator state rides in the
  checkpoint);
* dispatch supervision: a worker fault falls back inline with the same
  histories; a hung worker surfaces as ``DispatchError`` at
  ``result(timeout=)`` and recovery with an inline retry reproduces the
  lost chunk; the heartbeat tracker detects a silent worker;
* machine failure: the down window records zero throughput, the other
  machine is unaffected, tenant churn while a machine is down is refused,
  and an out-of-range machine target is refused;
* the sentinel: on and off give the same histories, poisoned telemetry is
  detected, detection restores from the last checkpoint and finishes with
  a clean run's history, and random fault schedules keep it green.
"""
import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # clean checkout: deterministic fallback sweep
    from _hypothesis_fallback import given, settings, st

from repro_torch.core.faults import SENTINEL_NAN, SENTINEL_OWNERSHIP, SentinelError
from repro_torch.core.fleet import DispatchError, FleetManager
from repro_torch.core.manager import CentralManager
from repro_torch.core.scenario import (
    Arrive,
    BandwidthDegrade,
    MachineFail,
    MachineRecover,
    Scenario,
    ScenarioSweep,
    SweepPoint,
    TelemetryCorrupt,
    run_sweep,
)
from repro_torch.core.simulator import WorkloadSpec
from repro_torch.runtime.fault_tolerance import HeartbeatTracker

P, FAST, BUDGET, CHUNK = 256, 96, 16, 4
SWEEP_KW = dict(num_pages=P, fast_capacity=FAST, migration_budget=BUDGET,
                policy_chunk=CHUNK, device="cpu")


def _scenario(events=(), n_epochs=16):
    return Scenario(name="chaos", n_epochs=n_epochs, events=(
        Arrive(0, WorkloadSpec("a", n_pages=80, t_miss=0.4, sets=((0.2, 0.8),))),
        Arrive(0, WorkloadSpec("b", n_pages=100, t_miss=0.5)),
        *events,
    ))


def _sweep(scn):
    return ScenarioSweep(scenario=scn, points=(
        SweepPoint(name="p0", seed=0), SweepPoint(name="p1", seed=1),
    ))


def _hist(res):
    return {k: [r.__dict__ for r in v.history] for k, v in res.results.items()}


def _assert_same_history(h1, h2, label=""):
    assert h1.keys() == h2.keys()
    for k in h1:
        assert len(h1[k]) == len(h2[k]), (label, k)
        for i, (a, b) in enumerate(zip(h1[k], h2[k])):
            for f in a:
                va, vb = a[f], b[f]
                same = (va == vb) or (isinstance(va, float) and np.isnan(va) and np.isnan(vb))
                assert same, (label, k, i, f, va, vb)


# ------------------------------------------------------------- sentinel
class TestSentinel:
    def test_sentinel_on_matches_off_and_stays_green(self):
        off = run_sweep(_sweep(_scenario()), **SWEEP_KW)
        on = run_sweep(_sweep(_scenario()), sentinel=True, **SWEEP_KW)
        _assert_same_history(_hist(off), _hist(on))
        assert on.restores == 0 and on.fallbacks == 0

    @pytest.mark.parametrize("kind,bit", [("tier", SENTINEL_OWNERSHIP), ("nan", SENTINEL_NAN)])
    def test_poisoned_telemetry_detected(self, kind, bit):
        evt = [TelemetryCorrupt(epoch=8, kind=kind, machine=0)]
        with pytest.raises(SentinelError) as ei:
            run_sweep(_sweep(_scenario(evt)), sentinel=True, **SWEEP_KW)
        assert str(bit) in str(ei.value)

    def test_sentinel_triggers_restore_and_finishes_clean(self, tmp_path):
        """Detection -> restore from the checkpoint -> replay (the transient
        corruption is not fired again) -> a clean run's history."""
        evt = [TelemetryCorrupt(epoch=8, kind="tier", machine=0)]
        res = run_sweep(_sweep(_scenario(evt)), sentinel=True, checkpoint_every=CHUNK,
                        checkpoint_dir=str(tmp_path), **SWEEP_KW)
        assert res.restores >= 1
        noop = [BandwidthDegrade(epoch=8, factor=1.0, machine=1)]
        gold = run_sweep(_sweep(_scenario(noop)), **SWEEP_KW)
        _assert_same_history(_hist(gold), _hist(res), "restore == clean")


# --------------------------------------------------- checkpoint / resume
class TestCheckpointResume:
    def test_kill_at_every_chunk_boundary_resumes_bit_identically(self, tmp_path):
        gold = _hist(run_sweep(_sweep(_scenario()), **SWEEP_KW))
        for stop in range(CHUNK, 16, CHUNK):
            ckdir = str(tmp_path / f"stop{stop}")
            part = run_sweep(_sweep(_scenario()), checkpoint_every=CHUNK,
                             checkpoint_dir=ckdir, stop_after=stop, **SWEEP_KW)
            assert part.partial, stop
            full = run_sweep(_sweep(_scenario()), checkpoint_every=CHUNK,
                             checkpoint_dir=ckdir, resume=True, **SWEEP_KW)
            assert not full.partial
            _assert_same_history(gold, _hist(full), f"resume@{stop}")

    def test_kill_while_machine_down_resumes_bit_identically(self, tmp_path):
        """The checkpoint holds the parked real state of a failed machine
        and parks it again on restore."""
        evs = [MachineFail(epoch=4, machine=1), MachineRecover(epoch=12, machine=1)]
        gold = _hist(run_sweep(_sweep(_scenario(evs)), **SWEEP_KW))
        ckdir = str(tmp_path / "down")
        part = run_sweep(_sweep(_scenario(evs)), checkpoint_every=CHUNK,
                         checkpoint_dir=ckdir, stop_after=8, **SWEEP_KW)
        assert part.partial
        full = run_sweep(_sweep(_scenario(evs)), checkpoint_every=CHUNK,
                         checkpoint_dir=ckdir, resume=True, **SWEEP_KW)
        _assert_same_history(gold, _hist(full), "resume-while-down")

    def test_resume_without_checkpoint_dir_rejected(self):
        with pytest.raises(ValueError):
            run_sweep(_sweep(_scenario()), resume=True, **SWEEP_KW)
        with pytest.raises(ValueError):
            run_sweep(_sweep(_scenario()), checkpoint_every=4, **SWEEP_KW)


# ------------------------------------------------- dispatch supervision
def _pair():
    mgrs = [CentralManager(num_pages=128, fast_capacity=32, migration_budget=8, max_tenants=3,
                           sample_period=1, seed=s, device="cpu") for s in (0, 1)]
    for m in mgrs:
        m.allocate(m.register(0.3), 100)
    return FleetManager(mgrs)


class TestDispatchSupervision:
    def test_worker_fault_falls_back_inline_bit_identically(self):
        """An injected worker crash mid-sweep: the sweep recovers, runs the
        chunk again inline with the same counts and deviates, stays inline,
        and the recorded history is unchanged."""
        gold = _hist(run_sweep(_sweep(_scenario()), **SWEEP_KW))

        def arm(fleet):
            fleet._chaos_fail_n = 1

        res = run_sweep(_sweep(_scenario()), on_fleet=arm, dispatch_timeout=60.0, **SWEEP_KW)
        assert res.fallbacks == 1
        assert res.pipeline is False
        _assert_same_history(gold, _hist(res), "fallback")

    def test_result_timeout_and_recovery(self):
        """A hung worker surfaces as DispatchError at result(timeout=), and
        recover_dispatch + an inline retry reproduce the lost chunk."""
        counts = np.zeros((2, 128), np.int64)
        counts[:, :24] = 50
        clean = _pair().run_epochs(2, counts=counts)
        fleet = _pair()
        fleet._chaos_delay_s = 2.0
        handle = fleet.run_epochs_async(2, counts=counts)
        with pytest.raises(DispatchError):
            handle.result(timeout=0.05)
        fleet.recover_dispatch()
        assert [m.epoch_index for m in fleet.machines] == [0, 0]
        res = fleet.run_epochs_async(2, counts=counts, inline=True).result()
        np.testing.assert_array_equal(res.stats.fmmr_now.numpy(), clean.stats.fmmr_now.numpy())
        np.testing.assert_array_equal(fleet.stacked_placement()[0],
                                      np.stack([m.tiers() for m in fleet.machines]))

    def test_worker_fault_is_sticky_until_recovery(self):
        fleet = _pair()
        fleet._chaos_fail_n = 1
        handle = fleet.run_epochs_async(2)
        with pytest.raises(DispatchError):
            handle.result(timeout=30.0)
        with pytest.raises(DispatchError):
            fleet.run_epochs_async(2)
        fleet.recover_dispatch()
        assert fleet.run_epochs(2).num_epochs == 2

    def test_heartbeat_detects_silent_worker(self):
        now = [0.0]
        hb = HeartbeatTracker([0], timeout=5.0, clock=lambda: now[0])
        hb.beat(0)
        now[0] = 3.0
        assert hb.check() == []
        now[0] = 9.0
        assert hb.check() == [0]
        hb.beat(0)  # liveness latches: a late beat does not resurrect
        assert hb.alive_hosts() == []

    def test_supervised_fleet_beats(self):
        now = [0.0]
        fleet = _pair()
        fleet.enable_supervision(timeout=5.0, clock=lambda: now[0])
        fleet.run_epochs(1)
        now[0] = 4.0
        assert fleet.check_worker() == []
        now[0] = 20.0
        assert fleet.check_worker() == [0]


# -------------------------------------------------- machine fail/recover
class TestMachineFailures:
    def test_fail_recover_window_and_isolation(self):
        evs = [MachineFail(epoch=4, machine=1), MachineRecover(epoch=8, machine=1)]
        res = run_sweep(_sweep(_scenario(evs)), sentinel=True, **SWEEP_KW)
        h = _hist(res)
        for r in h["p1"][4:8]:
            assert sum(r["throughput"].values()) == 0.0
            assert r["migrated_pages"] == 0
        for r in h["p1"][8:]:
            assert sum(r["throughput"].values()) > 0.0
        # machine 0 equals the same schedule with machine 1's failures
        # replaced by no-ops at the same epochs (the same chunk boundaries)
        noop = [BandwidthDegrade(epoch=4, factor=1.0, machine=1),
                BandwidthDegrade(epoch=8, factor=1.0, machine=1)]
        ref = run_sweep(_sweep(_scenario(noop)), **SWEEP_KW)
        _assert_same_history({"p0": h["p0"]}, {"p0": _hist(ref)["p0"]}, "isolation")

    def test_tenant_churn_while_down_rejected(self):
        evs = [MachineFail(epoch=4, machine=1),
               Arrive(6, WorkloadSpec("c", n_pages=10, t_miss=0.5)),
               MachineRecover(epoch=8, machine=1)]
        with pytest.raises(ValueError, match="schedule contract"):
            run_sweep(_sweep(_scenario(evs)), **SWEEP_KW)

    def test_machine_target_out_of_range_rejected(self):
        with pytest.raises(ValueError, match="targets machine"):
            run_sweep(_sweep(_scenario([MachineFail(epoch=4, machine=9)])), **SWEEP_KW)

    def test_fail_and_recover_twice_rejected(self):
        fleet = _pair()
        fleet.fail_machine(1)
        with pytest.raises(ValueError, match="already failed"):
            fleet.fail_machine(1)
        fleet.recover_machine(1)
        with pytest.raises(ValueError, match="not failed"):
            fleet.recover_machine(1)


# ------------------------------------ randomized schedules on the fleet
class TestRandomizedChaosSchedules:
    @settings(max_examples=4, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=1000),
           fail_at=st.integers(min_value=2, max_value=8),
           factor=st.floats(min_value=0.25, max_value=0.9))
    def test_fleet_sweep_sentinel_green_under_random_faults(self, seed, fail_at, factor):
        fail_at = 2 * (fail_at // 2) or 2
        evs = [MachineFail(epoch=fail_at, machine=1),
               BandwidthDegrade(epoch=fail_at, factor=factor),
               MachineRecover(epoch=min(fail_at + 4, 14), machine=1)]
        sweep = ScenarioSweep(scenario=_scenario(evs, n_epochs=16), points=(
            SweepPoint(name="p0", seed=seed % 11),
            SweepPoint(name="p1", seed=(seed + 1) % 11),
        ))
        res = run_sweep(sweep, sentinel=True, **SWEEP_KW)
        assert res.restores == 0
        for recs in _hist(res).values():
            assert len(recs) == 16
