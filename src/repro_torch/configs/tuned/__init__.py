"""Committed tuned policy profiles (the port's copy of the reference's store).

Each profile is one JSON file in this directory: the winning
``PolicyParams`` the fleet autotuner (``repro_torch.launch.hillclimb``)
found for one scenario family at one geometry, together with the measured
tuned-vs-default metrics and the search provenance that produced it. The
seven profiles here are byte-for-byte copies of the JAX package's
``src/repro/configs/tuned/*.json``; ``PolicyAutotuner.commit_profile``
writes new ones into this directory, never into the reference's.

Schema (one file, ``<name>.json``)::

    {
      "name": "thrash_4k",
      "family": "thrash",            # scenario family (launch/families.py)
      "geometry": {"n_pages": ..., "n_epochs": ..., "fast_capacity": ...,
                   "queue_size": ..., "max_tenants": ..., "policy_chunk": ...},
      "params": { <every PolicyParams field, host values> },
      "metrics": {"default": {"agg_throughput": ..., "ls_p99_us": ...},
                  "tuned":   {...}},
      "search": {"seed": ..., "generations": ..., "population": ...,
                 "score": ..., "scored_window": [a, b]}
    }

``params`` uses the sweep checkpoints' host encoding
(``runtime.fault_tolerance._params_to_meta``): a bool for ``fair_mode``,
floats for the float knobs, ints for the rest. ``params_from_profile``
turns it into the manager's form (Python scalars, float knobs rounded to
float32), so a profile round-trips exactly.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

_DIR = os.path.dirname(os.path.abspath(__file__))


def profiles_dir() -> str:
    return _DIR


def profile_path(name: str) -> str:
    return os.path.join(_DIR, f"{name}.json")


def profile_names() -> List[str]:
    """Sorted names of every committed profile."""
    return sorted(fn[: -len(".json")] for fn in os.listdir(_DIR) if fn.endswith(".json"))


def load_profile(name: str) -> Dict:
    path = profile_path(name)
    if not os.path.exists(path):
        raise KeyError(
            f"no tuned profile {name!r} under {_DIR} "
            f"(available: {profile_names()}); regenerate with "
            f"`python -m repro_torch.launch.hillclimb --scenario <family> "
            f"--commit-profile`"
        )
    with open(path) as f:
        prof = json.load(f)
    missing = {"name", "family", "geometry", "params"} - set(prof)
    if missing:
        raise ValueError(f"profile {name!r} is missing fields {sorted(missing)}")
    return prof


def save_profile(prof: Dict) -> str:
    """Write one profile dict (validated) to ``<name>.json``; returns path."""
    from repro_torch.core.types import PolicyParams

    missing = {"name", "family", "geometry", "params"} - set(prof)
    if missing:
        raise ValueError(f"profile is missing fields {sorted(missing)}")
    extra = set(prof["params"]) ^ set(PolicyParams._fields)
    if extra:
        raise ValueError(
            f"profile params must cover exactly PolicyParams._fields; "
            f"mismatch on {sorted(extra)}"
        )
    path = profile_path(prof["name"])
    with open(path, "w") as f:
        json.dump(prof, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def params_from_profile(name: str, **overrides):
    """Profile name -> fully-populated ``PolicyParams`` (the manager's
    Python scalars, float knobs rounded to float32)."""
    from repro_torch.runtime.fault_tolerance import _params_from_meta

    meta = dict(load_profile(name)["params"])
    unknown = set(overrides) - set(meta)
    if unknown:
        raise TypeError(f"unknown PolicyParams fields {sorted(unknown)}")
    meta.update(overrides)
    return _params_from_meta(meta)


def manager_kwargs(name: str) -> Dict:
    """Profile -> ``CentralManager(**kwargs)`` reconstructing the tuned
    machine: geometry shapes + every tunable constructor knob (add
    ``device=`` to choose where it runs)."""
    prof = load_profile(name)
    geo, par = prof["geometry"], prof["params"]
    kw = dict(
        num_pages=int(geo["n_pages"]),
        fast_capacity=int(par["fast_capacity"]),
        migration_budget=int(par["migration_budget"]),
        max_tenants=int(geo.get("max_tenants", 16)),
        num_bins=int(par["num_bins"]),
        sample_period=int(par["sample_period"]),
        ewma_lambda=float(par["ewma_lambda"]),
        fair_mode=bool(par["fair_mode"]),
        hysteresis=float(par["hysteresis"]),
        queue_size=int(geo.get("queue_size", 0)),
        migration_latency=int(par["migration_latency"]),
        alloc_headroom=int(par["alloc_headroom"]),
        # storm guards: the default-off sentinels round-trip too
        promote_band=float(par.get("promote_band", -1.0)),
        demote_band=float(par.get("demote_band", -1.0)),
        demote_cooldown=int(par.get("demote_cooldown", 0)),
    )
    adm = int(par.get("promote_admission", -1))
    if adm >= 0:
        kw["promote_admission"] = adm
    if int(par["migration_bandwidth"]) >= 0:
        kw["migration_bandwidth"] = int(par["migration_bandwidth"])
    return kw


__all__ = [
    "load_profile",
    "manager_kwargs",
    "params_from_profile",
    "profile_names",
    "profile_path",
    "profiles_dir",
    "save_profile",
]
