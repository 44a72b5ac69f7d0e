"""Command-line entry points of the port: ``serve`` (the serving slice),
``train`` (the trainer) and ``hillclimb`` (the policy autotuner). The autotuner's names are exported
lazily, so ``python -m repro_torch.launch.hillclimb`` runs the module once."""
import importlib

_HILLCLIMB = (
    "FAMILIES",
    "OnlineTuner",
    "PolicyAutotuner",
    "SEARCH_SPACE",
    "TunerGeometry",
    "TunerResult",
    "family_geometry",
    "family_scenario",
    "skewshift_scenario",
)


def __getattr__(name):
    if name in _HILLCLIMB:
        return getattr(importlib.import_module("repro_torch.launch.hillclimb"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_HILLCLIMB)
