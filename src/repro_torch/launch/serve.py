"""Multi-tenant tiered-KV serving driver on PyTorch (the paper's scenario,
end to end).

    PYTHONPATH=src python -m repro_torch.launch.serve --steps 80

Builds a smoke-scale model, a MaxMem central manager over a small fast
pool and a larger slow pool, registers a latency-sensitive and a
best-effort tenant, runs continuous-batching decode with Quest page
selection, and prints per-tenant FMMR and fast-page telemetry each epoch.
It runs on the card; ``--device cpu`` runs it on the CPU with the kernels'
plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.manager import CentralManager
from repro_torch.core.types import TIER_FAST
from repro_torch.kvcache.paged import TieredPagedKV
from repro_torch.models.model import get_model
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--fast-pages", type=int, default=8)
    ap.add_argument("--slow-pages", type=int, default=120)
    ap.add_argument("--page-tokens", type=int, default=4)
    ap.add_argument("--quest-pages", type=int, default=3)
    ap.add_argument("--ls-target", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    params = get_model(cfg).init(seed=0, device=args.device)

    manager = CentralManager(
        num_pages=args.fast_pages + args.slow_pages,
        fast_capacity=args.fast_pages,
        migration_budget=max(args.fast_pages, 8),
        max_tenants=4,
        sample_period=1,
        exact_sampling=True,
        device=args.device,
    )
    kv = TieredPagedKV(cfg, args.fast_pages, args.slow_pages,
                       page_tokens=args.page_tokens, device=args.device)
    eng = ServingEngine(
        cfg, params, manager, kv,
        max_batch=2, pages_per_seq=16, quest_pages=args.quest_pages,
        epoch_steps=4,
    )
    eng.add_tenant("ls", t_miss=args.ls_target)
    eng.add_tenant("be", t_miss=1.0)

    rng = np.random.default_rng(0)
    eng.submit("ls", rng.integers(1, cfg.vocab_size, 16), max_new_tokens=args.steps)
    eng.submit("be", rng.integers(1, cfg.vocab_size, 16), max_new_tokens=args.steps)

    print(f"{'step':>5} {'LS fmmr':>8} {'BE fmmr':>8} {'LS fast':>8} "
          f"{'BE fast':>8} {'moved':>6}")
    for _ in range(args.steps + 8):
        eng.step()
        if eng._epoch_log and eng._epoch_log[-1]["step"] == eng.step_count:
            e = eng._epoch_log[-1]
            owner, tier = manager.owners(), manager.tiers()
            ls_fast = int(((owner == int(eng.tenant_handles["ls"])) & (tier == TIER_FAST)).sum())
            be_fast = int(((owner == int(eng.tenant_handles["be"])) & (tier == TIER_FAST)).sum())
            print(f"{e['step']:>5} {e['fmmr'].get('ls', 0):>8.3f} "
                  f"{e['fmmr'].get('be', 0):>8.3f} {ls_fast:>8} {be_fast:>8} "
                  f"{e['moved']:>6}")

    for t in ("ls", "be"):
        pct = eng.latency_percentiles(t)
        if pct:
            print(f"{t}: p50={pct['p50'] * 1e6:.1f}us p99={pct['p99'] * 1e6:.1f}us "
                  f"mean={pct['mean'] * 1e6:.1f}us")
    print(f"migrated pages total: {eng._migrated_pages}")
    print(f"completed requests: {len(eng.finished)}")
    return eng


if __name__ == "__main__":
    main()
