"""Command-line entry points of the port: ``serve`` (the serving slice),
``train`` (the trainer, ``--mesh test|prod`` on a device mesh), ``dryrun``
(every arch x shape x mesh cell counted on a fake process group) and
``hillclimb`` (the policy autotuner); and the mesh layer they use:
``mesh`` (``DeviceMesh`` construction), ``partitioning`` (logical axes,
``shard``, ``PartitionSpec`` -> ``DTensor`` placements) and ``shardings``
(per-architecture rules and the parameter, batch, cache and train-state
shardings). The autotuner's names are exported lazily, so ``python -m
repro_torch.launch.hillclimb`` runs the module once."""
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
