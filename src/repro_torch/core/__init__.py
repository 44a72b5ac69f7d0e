"""MaxMem core on PyTorch: FMMR QoS policy, hotness bins, sampling, the
central manager and the page data plane; the fleet of managers advanced by
one batched tick; the colocation simulator, the placement baselines and the
dynamic-scenario engine that drive them, and its sweep over a fleet."""
from repro_torch.core.policy import apply_plan, policy_epoch
from repro_torch.core.baselines import AutoNUMALike, HeMemStatic, TwoLM
from repro_torch.core.fleet import (
    DispatchError,
    FleetManager,
    FleetMultiEpochResult,
    fleet_multi_epoch,
)
from repro_torch.core.manager import CentralManager, TenantHandle
from repro_torch.core.scenario import (
    STORM_FAMILIES,
    PhaseStats,
    Scenario,
    ScenarioResult,
    ScenarioSweep,
    SweepPoint,
    SweepResult,
    adversarial_scenario,
    recovery_epochs,
    run_scenario,
    run_sweep,
    scale_colocation,
    storm_scenario,
)
from repro_torch.core.simulator import (
    OPTANE,
    TPU_HOST,
    ColocationSim,
    EpochRecord,
    MachineSpec,
    TierSpec,
    WorkloadSpec,
)
from repro_torch.core.types import (
    TIER_FAST,
    TIER_NONE,
    TIER_SLOW,
    EpochStats,
    MigrationPlan,
    OwnerSegments,
    PageState,
    PolicyParams,
    TenantState,
)

__all__ = [
    "AutoNUMALike",
    "CentralManager",
    "ColocationSim",
    "DispatchError",
    "EpochRecord",
    "FleetManager",
    "FleetMultiEpochResult",
    "HeMemStatic",
    "MachineSpec",
    "OPTANE",
    "PhaseStats",
    "STORM_FAMILIES",
    "Scenario",
    "ScenarioResult",
    "ScenarioSweep",
    "SweepPoint",
    "SweepResult",
    "TPU_HOST",
    "TierSpec",
    "TwoLM",
    "WorkloadSpec",
    "adversarial_scenario",
    "apply_plan",
    "fleet_multi_epoch",
    "policy_epoch",
    "recovery_epochs",
    "run_scenario",
    "run_sweep",
    "scale_colocation",
    "storm_scenario",
    "TenantHandle",
    "TIER_FAST",
    "TIER_NONE",
    "TIER_SLOW",
    "EpochStats",
    "MigrationPlan",
    "OwnerSegments",
    "PageState",
    "PolicyParams",
    "TenantState",
]
