"""Multi-pod dry-run: count every (arch x shape x mesh) cell's local program
on a fake process group, the reference's ``launch/dryrun.py`` on PyTorch.

The reference lowers and compiles each cell for 512 placeholder devices and
reads the HLO. Eager PyTorch has no compiler to ask, so the port runs the
cell once, as rank 0 of a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective returns
at once), on ``FakeTensorMode`` tensors (shapes only, nothing allocated),
its state and inputs distributed as ``DTensor``s by the cell's specs. It
records:

  * ``analysis.hlo_cost.module_cost`` of that run: FLOPs, bytes and the
    functional collectives' bytes of rank 0's local program (every layer
    and, for a train cell, the backward and remat's recompute; the kernel
    entry points report their analytic costs, and on fake tensors launch
    nothing);
  * ``analysis.roofline.compute_terms`` on H100 constants;
  * ``memory``: argument and output bytes from the local shard shapes;
    ``temp_bytes`` and ``peak_bytes`` from the same counted run, whose
    counter follows the live storages of rank 0's blocks on the cell's fake
    device (``analysis.memory``: blocks of the CUDA caching allocator; the
    reference reads XLA's buffer assignment, which eager PyTorch has not):
    ``peak_bytes`` is the arguments plus the highest live bytes the run
    created, ``temp_bytes`` the peak less the arguments. ``generated_code_bytes``
    is null, and so is ``xla_cost_analysis``, kept as a key; ``compile_seconds``
    is null (nothing compiles) and ``count_seconds`` is the counted run's wall.

Results land in ``results/dryrun_torch/<testmesh|singlepod|multipod>/
<arch>__<shape>.json``.

Usage (the tensors are ``cuda`` fakes by default; ``--device cpu`` here):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # single pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod  # 2 pods
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k \\
      --test-mesh --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.analysis import memory
from repro_torch.analysis.hlo_cost import CostCounter
from repro_torch.analysis.roofline import compute_terms
from repro_torch.configs import ARCH_NAMES, applicable_shapes, get_config, get_shape
from repro_torch.core.manager import resolve_device
from repro_torch.launch import partitioning as part
from repro_torch.launch.mesh import build_mesh, mesh_shape
from repro_torch.launch.shardings import (
    batch_specs,
    cache_sharding,
    params_sharding,
    rules_for,
    train_state_sharding,
)
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models.model import get_model, input_specs
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_state import init_train_state, make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


def _prefill_fn(cfg, shape):
    """Family-dispatched prefill step (logits + cache for the full prompt)."""
    max_len = shape.seq_len
    if cfg.family in ("dense", "moe", "vlm"):
        return lambda params, batch: transformer.prefill(params, batch["tokens"], cfg, max_len)
    if cfg.family == "ssm":
        return lambda params, batch: ssm_lm.prefill(params, batch["tokens"], cfg, max_len)
    if cfg.family == "hybrid":
        return lambda params, batch: hybrid.prefill(params, batch["tokens"], cfg, max_len)
    if cfg.family == "audio":
        return lambda params, batch: encdec.prefill(params, batch["enc_embeds"],
                                                    batch["tokens"], cfg, max_len)
    raise ValueError(cfg.family)


def _inputs(cfg, shape, device):
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in input_specs(cfg, shape).items()}


def build_cell(cfg, shape, mesh, rules, *, remat: str = "block", microbatch: int = 1,
               device=None):
    """(fn, args): one run of ``fn(*args)`` is the cell's step, its state and
    inputs distributed by the cell's specs, on ``device`` (default: the
    card). Call it under ``FakeTensorMode`` (the state is built whole before
    it is distributed)."""
    device = resolve_device(device, what="the dry-run")
    api = get_model(cfg)
    if shape.kind == "train":
        step = make_train_step(cfg, AdamWConfig(total_steps=10_000), remat=remat,
                               microbatch=microbatch)
        state = init_train_state(cfg, 0, device=device)
        state = part.distribute(state, train_state_sharding(state, mesh, rules))
        batch = part.distribute(_inputs(cfg, shape, device),
                                batch_specs(cfg, shape, mesh, rules))
        return step, (state, batch)

    params = api.init(0, device=device)
    params = part.distribute(params, params_sharding(params, mesh, rules))
    if shape.kind == "prefill":
        batch = part.distribute(_inputs(cfg, shape, device),
                                batch_specs(cfg, shape, mesh, rules))
        return _prefill_fn(cfg, shape), (params, batch)

    # decode / long-context decode: one serve step over an S-token cache
    B, S = shape.global_batch, shape.seq_len
    cache = api.init_cache(B, S, device=device)
    cache = part.distribute(cache, cache_sharding(cache, cfg, mesh, rules))
    token = part.distribute(_inputs(cfg, shape, device),
                            batch_specs(cfg, shape, mesh, rules))["token"]
    return api.decode, (params, token, cache)


def _fake_group(n: int) -> None:
    """This process as rank 0 of a fake process group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             test_mesh: bool = False, remat: str = "block", microbatch: int = 1,
             out_dir: str = RESULTS_DIR, save: bool = True, verbose: bool = True,
             device=None) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = resolve_device(device, what="the dry-run")
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    dims, names = mesh_shape("test" if test_mesh else "prod", multi_pod)
    n_chips = math.prod(dims)
    _fake_group(n_chips)
    mesh = build_mesh(dims, names, device_type=dev.type)
    rules = rules_for(cfg, mesh, shape)

    with FakeTensorMode(), part.use_partitioning(mesh, rules):
        fn, args = build_cell(cfg, shape, mesh, rules, remat=remat, microbatch=microbatch,
                              device=dev)
        t0 = time.time()
        with CostCounter(device=dev) as counter:
            out = fn(*args)
        count_s = time.time() - t0
        mem = memory.analysis(args, out, counter.live).as_dict()
        mc = counter.cost

    terms = compute_terms(cfg, shape, n_chips, mc.flops, mc.bytes, float(mc.coll_total))
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": list(dims),
        "axes": list(names),
        "n_chips": n_chips,
        "remat": remat,
        "microbatch": microbatch,
        "device": dev.type,
        "compile_seconds": None,
        "count_seconds": count_s,
        "flops_per_device": mc.flops,
        "bytes_per_device": mc.bytes,
        "xla_cost_analysis": {"flops": None, "bytes": None},
        "collective_bytes": dict(mc.coll_bytes),
        "collective_counts": dict(mc.coll_counts),
        "collective_bytes_total": mc.coll_total,
        "kernel_calls": dict(mc.kernel_calls),
        "memory": mem,
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "step_time_lower_bound_s": terms.step_time_s,
            "model_flops": terms.model_flops,
            "useful_ratio": terms.useful_ratio,
            "roofline_fraction": terms.roofline_fraction,
        },
    }
    if save:
        sub = "multipod" if multi_pod else ("testmesh" if test_mesh else "singlepod")
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(result, f, indent=1)
    if verbose:
        r = result["roofline"]
        print(f"[{'2pod' if multi_pod else '1pod'}] {arch:22s} {shape_name:12s} "
              f"count={count_s:6.1f}s flops/dev={mc.flops:.4e} bytes/dev={mc.bytes:.4e} "
              f"coll={mc.coll_total:.4e}B {dict(mc.coll_bytes)} dom={r['dominant']:10s} "
              f"useful={r['useful_ratio']:.3f} frac={r['roofline_fraction']:.3f}")
        print(f"    memory_analysis: {mem}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--test-mesh", action="store_true")
    ap.add_argument("--remat", default="block")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the card; 'cpu' on the CPU)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, s.name) for arch in ARCH_NAMES
                 for s in applicable_shapes(get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = []
    try:
        for mp in meshes:
            for arch, shape in cells:
                try:
                    run_cell(arch, shape, multi_pod=mp, test_mesh=args.test_mesh,
                             remat=args.remat, microbatch=args.microbatch,
                             out_dir=args.out_dir, device=args.device)
                except Exception as e:  # one cell's failure is reported, the sweep goes on
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAILED [{'2pod' if mp else '1pod'}] {arch} {shape}: {e}")
                    traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n = len(cells) * len(meshes)
    print(f"\n{n - len(failures)}/{n} cells counted")
    if failures:
        for f in failures:
            print("  FAIL:", f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
