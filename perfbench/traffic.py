"""The one traffic generator: everything it draws comes from a workload's
data file, a configuration's sizes and ``--seed``. The same seed gives the
same traffic; another seed gives the same kind of traffic in another draw.
"""
from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, what: str) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` and a name."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, what))
    return g


# ----------------------------------------------------- tiered-memory tenants
def ops_per_epoch(tenant: dict, machine: dict, slow_share: float) -> float:
    """Operations a closed-loop tenant issues in one epoch: its threads over
    the mean latency of one operation, a tier's latency plus the value's
    transfer at the tier's bandwidth, missing in the machine's slow share."""
    nbytes = max(tenant["value_bytes"], machine["access_bytes"])
    fast_ns = machine["fast_latency_ns"] + nbytes / machine["fast_GBps"]
    slow_ns = machine["slow_latency_ns"] + nbytes / machine["slow_GBps"]
    lat_ns = (1 - slow_share) * fast_ns + slow_share * slow_ns
    return tenant["threads"] / lat_ns * 1e9 * machine["epoch_s"]


def page_rates(cfg: dict, pages_of, seed: int, device) -> torch.Tensor:
    """f32[P] expected accesses a page an epoch. Each tenant issues its
    operations at the source machine's rate, times the share of that
    machine's pages the configuration holds, so that a page is accessed as
    often as on the source. A tenant with a ``hot`` set puts ``hot_accesses``
    of its operations on ``hot_pages`` of its pages, drawn from the seed, and
    the rest on the others; a tenant without one spreads them evenly."""
    P = cfg["pages"]
    slow_share = 1 - cfg["fast_capacity"] / P
    share = P / cfg["source_machine"]["pages"]
    rates = torch.zeros(P, dtype=torch.float32, device=device)
    for t, ids in zip(cfg["tenants"], pages_of):
        ids = ids.to(device)
        n = ids.shape[0]
        ops = ops_per_epoch(t, cfg["machine"], slow_share) * share
        hot = t.get("hot")
        if hot is None:
            rates[ids] = ops / n
            continue
        g = generator(seed, f"hot:{t['name']}", device)
        perm = ids[torch.randperm(n, generator=g, device=device)]
        k = int(hot["pages"] * n)
        rates[perm[:k]] = hot["accesses"] * ops / k
        rates[perm[k:]] = (1 - hot["accesses"]) * ops / (n - k)
    return rates


def epoch_cycle(rates: torch.Tensor, epochs: int, seed: int) -> torch.Tensor:
    """i64[epochs, P] access counts, each epoch Poisson around the rates."""
    g = generator(seed, "accesses", rates.device)
    return torch.stack([torch.poisson(rates, generator=g).to(torch.int64)
                        for _ in range(epochs)])
