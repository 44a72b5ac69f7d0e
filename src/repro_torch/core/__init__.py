"""MaxMem core on PyTorch: FMMR QoS policy, hotness bins, sampling, the
central manager and the page data plane; the colocation simulator, the
placement baselines and the dynamic-scenario engine that drive it."""
from repro_torch.core.baselines import AutoNUMALike, HeMemStatic, TwoLM
from repro_torch.core.manager import CentralManager, TenantHandle
from repro_torch.core.scenario import (
    STORM_FAMILIES,
    PhaseStats,
    Scenario,
    ScenarioResult,
    adversarial_scenario,
    run_scenario,
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
    "EpochRecord",
    "HeMemStatic",
    "MachineSpec",
    "OPTANE",
    "PhaseStats",
    "STORM_FAMILIES",
    "Scenario",
    "ScenarioResult",
    "TPU_HOST",
    "TierSpec",
    "TwoLM",
    "WorkloadSpec",
    "adversarial_scenario",
    "run_scenario",
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
