"""MaxMem core on PyTorch: FMMR QoS policy, hotness bins, sampling, the
central manager and the page data plane."""
from repro_torch.core.manager import CentralManager, TenantHandle
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
    "CentralManager",
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
