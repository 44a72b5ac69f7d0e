"""The port's placement baselines (``repro_torch.core.baselines``).

They are a numpy copy of the reference's: the golden churn trace
(``tests/golden/baseline_traces.json``, recorded from the frozen seed
per-page implementations) must replay bit for bit, each baseline must
place pages as the reference's does under the simulator, and unregistering
must scrub a tenant's telemetry.
"""
import dataclasses
import json

import numpy as np
import pytest

import golden_regen
import repro.core.baselines as jax_baselines
import repro_torch.core.baselines as torch_baselines
from repro.core.simulator import OPTANE as JAX_OPTANE
from repro.core.simulator import ColocationSim as JaxSim
from repro.core.simulator import WorkloadSpec as JaxSpec
from repro_torch.core.simulator import OPTANE, ColocationSim, WorkloadSpec

NAMES = ("hemem", "autonuma", "twolm")


@pytest.mark.parametrize("name", NAMES)
def test_baselines_replay_the_golden_trace(name):
    with open(golden_regen.BASELINE_TRACE_PATH) as f:
        golden = json.load(f)["traces"][name]
    got = golden_regen.drive_baseline(golden_regen.backend_factories(torch_baselines)[name])
    assert len(got) == len(golden)
    for e, (g, n) in enumerate(zip(golden, got)):
        assert n == g, f"{name} epoch {e} diverged"


def _make(mod, name):
    P, fast = 1024, 256
    return {
        "hemem": lambda: mod.HeMemStatic(P, fast, partitions={0: 128, 1: 96, 2: 64},
                                         hot_threshold=4, migration_budget=64, seed=3),
        "autonuma": lambda: mod.AutoNUMALike(P, fast, seed=3),
        "twolm": lambda: mod.TwoLM(P, fast, seed=3),
    }[name]()


@pytest.mark.parametrize("name", NAMES)
def test_baselines_under_the_simulator_match_the_reference(name):
    """Three tenants, a hot-set resize and a departure: every epoch record
    (floats exact), the final placement and the FMMR telemetry equal."""
    runs = []
    for mod, Sim, Spec, machine in ((jax_baselines, JaxSim, JaxSpec, JAX_OPTANE),
                                    (torch_baselines, ColocationSim, WorkloadSpec, OPTANE)):
        b = _make(mod, name)
        sim = Sim(b, machine, seed=5)
        # skew sets that take every access leave cold pages to evict
        sim.add_tenant(Spec("ls", n_pages=384, t_miss=0.1, threads=2, sets=((0.3, 1.0),)))
        sim.add_tenant(Spec("be", n_pages=320, t_miss=1.0, threads=8))
        sim.add_tenant(Spec("kv", n_pages=200, t_miss=0.3, threads=4, sets=((0.2, 1.0),)))
        sim.run(12, events={5: lambda s: s.tenants["ls"].resize_set(0, 0.7),
                            9: lambda s: s.remove_tenant("kv")})
        runs.append((sim.history, np.asarray(b.tiers()).copy(), dict(b._ewma)))
    (jh, jt, je), (th, tt, te) = runs
    assert sum(r.migrated_pages for r in jh) > 0
    assert [repr(dataclasses.asdict(r)) for r in th] == [repr(dataclasses.asdict(r)) for r in jh]
    assert np.array_equal(tt, jt)
    assert te == je


@pytest.mark.parametrize("name", NAMES)
def test_baseline_unregister_drops_fmmr(name):
    cls = {"hemem": torch_baselines.HeMemStatic, "autonuma": torch_baselines.AutoNUMALike,
           "twolm": torch_baselines.TwoLM}[name]
    b = cls(128, 16)
    h = b.register(0.5)
    pages = b.allocate(h, 64)
    counts = np.zeros(128, np.int64)
    counts[pages] = 50
    b.record_access(counts)
    b.run_epoch()
    assert b.fmmr_of(h) > 0.0
    b.unregister(h)
    assert b.fmmr_of(h) == 0.0
    assert h not in b._ewma
