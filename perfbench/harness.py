"""One run of one cell: set-up, the measured window (traced or not), the
readings, the check of what the window produced, and the result line.

``run_cell`` takes the device it is given and never looks for a card;
``run.py`` looks, and refuses to run without one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded once the window has closed:
# the JAX stack and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_cell(name: str, bench_path: Optional[str] = None) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic
    and metric entries: {"workload", "config", "traffic", "end_to_end",
    "per_layer"}."""
    with open(bench_path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as f:
        traffic = json.load(f)

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {"workload": wl, "config": cfg, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a per-layer reader sees of the traced run: the cell, the traced
    window's device trace, and the counters the system driver took."""

    def __init__(self, cell: dict, counters: dict, trace, window_s: float):
        self.cell, self.counters, self.trace, self.window_s = cell, counters, trace, window_s


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, peak: int, tr=None) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
             log=sys.stderr) -> dict:
    """Run the cell once on ``device`` and return its result line (a dict).
    ``t_start`` is the host clock at the process's start: set-up is
    everything until the window opens."""
    from perfbench import trace

    device = torch.device(device)
    system = importlib.import_module(f"perfbench.systems.{cell['config']['system']}")
    sut = system.System(cell["config"], cell["traffic"], seed, device)
    sut.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    out: dict = {}
    if traced:
        with sut.instrument(), trace.traced(out):
            w = sut.window(seconds)
    else:
        w = sut.window(seconds)
    failed = sut.failed()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    if traced:
        run = Run(cell, sut.layer, out["trace"], w["wall_s"])
        for m in cell["per_layer"]:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(w["e2e"], setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    print(f"window: {w['attempted']} attempted, {failed} failed, {w['wall_s']:.3f} s; "
          f"set-up {setup_s:.3f} s; peak {peak} bytes", file=log, flush=True)
    t0 = time.perf_counter()
    checks = sut.verify()
    print(f"check: {time.perf_counter() - t0:.3f} s", file=log, flush=True)
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": w["attempted"], "failed": failed,
              "metrics": metrics,
              "device": device_info(device, peak, out.get("trace"))}
    if traced:
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
