"""Scenario families of the autotuner, the port's own copies.

The reference's ``launch/hillclimb.family_scenario`` builds these from
``benchmarks/dynamic_workload.py``; the port imports nothing of
``benchmarks`` (it imports the JAX package), so the builders are copied
here on the port's scenario engine. Each docstring cites its source lines.
``skewshift_scenario`` lives in ``launch/hillclimb.py`` as in the
reference, ``adversarial_scenario`` in ``core/scenario.py``.
"""
from __future__ import annotations

from repro_torch.core.scenario import (
    Arrive,
    BandwidthDegrade,
    Depart,
    MachineFail,
    MachineRecover,
    ResizeWorkingSet,
    Scenario,
    SetMigrationBandwidth,
    SweepPoint,
    pingpong_schedule,
)
from repro_torch.core.simulator import WorkloadSpec


def colocation_scenario(n_pages: int, n_epochs: int) -> Scenario:
    """``benchmarks/dynamic_workload.py:127-158``: two latency-sensitive
    tenants whose hot sets together almost fill the fast tier, a
    best-effort GUPS tenant that arrives at a quarter and departs at five
    eighths, and the KVS hot set growing at half. Both LS targets are
    reachable (miss floor below t_miss - hysteresis)."""
    kvs = (3 * n_pages) // 8  # hot 0.18*kvs = 0.0675*P of F = 0.125*P
    gap = n_pages // 4  # hot 0.20*gap = 0.0500*P
    gups = (3 * n_pages) // 16
    a, b, c = n_epochs // 4, n_epochs // 2, (5 * n_epochs) // 8
    return Scenario(
        name=f"colocation_dynamic_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            Arrive(0, WorkloadSpec("kvs", n_pages=kvs, t_miss=0.2, threads=4,
                                   sets=((0.18, 0.9),))),
            Arrive(0, WorkloadSpec("gapbs", n_pages=gap, t_miss=0.4, threads=8,
                                   sets=((0.2, 0.7),))),
            Arrive(a, WorkloadSpec("gups", n_pages=gups, t_miss=1.0, threads=8)),
            ResizeWorkingSet(b, "kvs", 0, 0.21),
            Depart(c, "gups"),
        ),
        description="arrive/depart + hot-set growth at fused-engine scale",
    )


def thrash_scenario(n_pages: int, n_epochs: int) -> Scenario:
    """``benchmarks/dynamic_workload.py:204-242``: two tenants whose hot
    sets contend for the fast tier; after an eighth of the run the DMA
    bandwidth drops to a quarter of the migration budget and the KVS hot
    set ping-pongs between two scatters faster than the queue drains;
    bandwidth is restored for the last eighth. The tenants have hot and
    warm sets with a cold tail."""
    kvs = (3 * n_pages) // 8
    gap = n_pages // 4
    fast = n_pages // 8
    budget = max(fast // 8, 8)
    a, b = n_epochs // 8, (7 * n_epochs) // 8
    period = max(n_epochs // 16, 2)
    return Scenario(
        name=f"thrash_pingpong_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            Arrive(0, WorkloadSpec("kvs", n_pages=kvs, t_miss=0.2, threads=4,
                                   sets=((0.18, 0.95), (0.4, 0.05)))),
            Arrive(0, WorkloadSpec("gapbs", n_pages=gap, t_miss=0.4, threads=8,
                                   sets=((0.2, 0.8), (0.4, 0.2)))),
            SetMigrationBandwidth(a, max(budget // 4, 2)),
            *pingpong_schedule("kvs", n_epochs // 4, b, period),
            SetMigrationBandwidth(b, None),
        ),
        description="ping-pong working-set thrash under bounded DMA bandwidth",
    )


def faults_scenario(n_pages: int, n_epochs: int) -> Scenario:
    """``benchmarks/dynamic_workload.py:244-275``: the colocation pair runs
    into a DMA engine degraded to a quarter at a quarter of the run, the
    machine fails at three eighths and recovers at five eighths, and
    bandwidth is restored for the last quarter."""
    kvs = (3 * n_pages) // 8
    gap = n_pages // 4
    a, f, r, b = (n_epochs // 4, (3 * n_epochs) // 8,
                  (5 * n_epochs) // 8, (3 * n_epochs) // 4)
    return Scenario(
        name=f"faults_fail_degrade_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=(
            Arrive(0, WorkloadSpec("kvs", n_pages=kvs, t_miss=0.2, threads=4,
                                   sets=((0.18, 0.9),))),
            Arrive(0, WorkloadSpec("gapbs", n_pages=gap, t_miss=0.4, threads=8,
                                   sets=((0.2, 0.7),))),
            BandwidthDegrade(a, 0.25),
            MachineFail(f),
            MachineRecover(r),
            BandwidthDegrade(b, 1.0),
        ),
        description="machine failure inside a degraded-bandwidth window",
    )


def sweep_scenario(n_pages: int, n_epochs: int, max_tenants: int = 16) -> Scenario:
    """``benchmarks/dynamic_workload.py:355-385``: 8 latency-sensitive
    tenants (t_miss 0.3) and 6 best-effort ones at epoch 0, ``gups``
    arriving at a quarter, ``ls0``'s hot set resized at half, ``gups``
    leaving at three quarters. The event epochs sit on quarter boundaries,
    so a ``policy_chunk`` dividing n_epochs/4 sees one chunk shape."""
    n_ls, n_be = 8, 6
    share = n_pages // (n_ls + n_be + 2)  # headroom for the churn tenant
    a, b, c = n_epochs // 4, n_epochs // 2, (3 * n_epochs) // 4
    events = [
        Arrive(0, WorkloadSpec(f"ls{i}", n_pages=share, t_miss=0.3, threads=4,
                               sets=((0.2, 0.85),)))
        for i in range(n_ls)
    ]
    events += [
        Arrive(0, WorkloadSpec(f"be{i}", n_pages=share, t_miss=1.0, threads=8,
                               sets=((0.3, 0.6),)))
        for i in range(n_be)
    ]
    events += [
        Arrive(a, WorkloadSpec("gups", n_pages=share, t_miss=1.0, threads=8)),
        ResizeWorkingSet(b, "ls0", 0, 0.3),
        Depart(c, "gups"),
    ]
    return Scenario(
        name=f"sweep_colocation_{n_pages // 1024}k",
        n_epochs=n_epochs,
        events=tuple(events),
        description="dense colocation mix for the fleet sweep benchmark",
    )


def sweep_points(n_machines: int, base_budget: int) -> tuple:
    """``benchmarks/dynamic_workload.py:387-399``: the seed x
    migration-budget grid (every knob per machine, one batched tick)."""
    budgets = (None, 2 * base_budget, base_budget // 2, base_budget // 4)
    return tuple(
        SweepPoint(
            name=f"seed{s}_bw{budgets[b] or 'dflt'}",
            seed=s,
            migration_budget=budgets[b],
        )
        for i in range(n_machines)
        for s, b in [(i // len(budgets), i % len(budgets))]
    )
