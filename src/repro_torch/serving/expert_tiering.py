"""MoE expert-weight tiering: MaxMem's second big-data object (the
reference's ``serving/expert_tiering.py``).

A *page* here is one (layer, expert) weight block (its w_gate, w_up and
w_down rows, 5.5 MiB each at qwen2-moe-a2.7b's width in bf16) in pooled
storage: slots [0, n_fast) are the fast tier, the rest the slow tier.
Routing skew (top-k gating concentrates traffic on few experts) is the heat
signal: each step's routed expert counts feed the central manager exactly
like KV-page touches, and the policy's plan moves hot experts into the fast
slots through the ``page_move`` kernel.

``moe_layer_from_pools`` reads each layer's expert weights from the pools
by physical slot, so migrations change where real data lives, not just
bookkeeping; its result does not depend on the placement.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.manager import CentralManager
from repro_torch.core.types import MigrationPlan
from repro_torch.kernels import ops
from repro_torch.models import moe


class ExpertPools(NamedTuple):
    w_gate: torch.Tensor  # [n_slots, d, ff]
    w_up: torch.Tensor  # [n_slots, d, ff]
    w_down: torch.Tensor  # [n_slots, ff, d]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class ExpertTierManager:
    """Tiered storage and QoS manager for one MoE model's expert weights.

    Logical page id = layer * E + expert. The model is the tenant (one
    t_miss per model; several colocated models could each register one).
    The manager runs on ``device`` (``None`` = the card); the pools live
    where the params given to :meth:`build_pools` live."""

    def __init__(self, cfg, n_fast_slots: int, t_miss: float = 0.1,
                 migration_budget: int = 8, epoch_steps: int = 8, device=None):
        self.cfg = cfg
        L, E = cfg.num_layers, cfg.num_experts
        self.n_pages = L * E
        self.n_fast = n_fast_slots
        self.n_slots = self.n_pages  # 1:1 slots (a permutation), like the KV cache
        if n_fast_slots > self.n_slots:
            raise ValueError(f"{n_fast_slots} fast slots for {self.n_slots} expert pages")
        self.manager = CentralManager(
            num_pages=self.n_pages,
            fast_capacity=n_fast_slots,
            migration_budget=migration_budget,
            max_tenants=2,
            sample_period=1,
            exact_sampling=True,
            device=device,
        )
        self.tenant = self.manager.register(t_miss=t_miss)
        self.manager.allocate(self.tenant, self.n_pages)
        self.slot_of = np.arange(self.n_slots, dtype=np.int32)
        self.epoch_steps = epoch_steps
        self._step = 0
        self.pools: Optional[ExpertPools] = None
        # plan entries that could not run because the 1:1 slot layout pairs
        # every promotion with a demotion: an odd plan's remainder is
        # counted here instead of being silently dropped
        self.unpaired_promotes = 0
        self.unpaired_demotes = 0

    # ------------------------------------------------------------- pools
    def build_pools(self, params) -> ExpertPools:
        """Copy the real experts of the stacked MoE weights [L, Ep, ...]
        into pools [L*E, ...] (the pad experts stay behind)."""
        w = params["layers"]["moe"]
        L, E = self.cfg.num_layers, self.cfg.num_experts

        def pack(x):
            out = torch.empty((L * E, *x.shape[2:]), dtype=x.dtype, device=x.device)
            out.view(L, E, *x.shape[2:]).copy_(x[:, :E])
            return out

        self.pools = ExpertPools(w_gate=pack(w["w_gate"]), w_up=pack(w["w_up"]),
                                 w_down=pack(w["w_down"]))
        return self.pools

    def slot_table(self) -> torch.Tensor:
        """[L, E] physical slot of each (layer, expert), on the host."""
        L, E = self.cfg.num_layers, self.cfg.num_experts
        return torch.as_tensor(self.slot_of.reshape(L, E).copy())

    # ------------------------------------------------------------- accounting
    def record_routing(self, expert_counts) -> None:
        """expert_counts: [L, E] routed-assignment counts of the step (numpy
        or a tensor)."""
        if isinstance(expert_counts, torch.Tensor):
            self.manager.record_access(expert_counts.reshape(-1))
        else:
            self.manager.record_access(np.asarray(expert_counts, np.int64).reshape(-1))
        self._step += 1

    def maybe_epoch(self) -> int:
        """Run a policy epoch every ``epoch_steps`` steps; returns the rows
        moved."""
        if self._step % self.epoch_steps != 0 or self._step == 0:
            return 0
        return self._migrate(self.manager.run_epoch().plan)

    # ------------------------------------------------------------- migration
    def _migrate(self, plan: MigrationPlan) -> int:
        promote = _host(plan.promote)
        demote = _host(plan.demote)
        promote = promote[promote >= 0]
        demote = demote[demote >= 0]
        if len(promote) == 0 and len(demote) == 0:
            return 0
        # every page is allocated (1:1 slots): migrations are paired swaps of
        # a promoted page with a demoted page. page_move has gather semantics
        # (every read sees the pre-plan pool), so the swap src=[a, b],
        # dst=[b, a] is exact with no spare slot; the kernel stages each
        # such entry through its scratch
        src: List[int] = []
        dst: List[int] = []
        promote = [int(p) for p in promote if int(self.slot_of[p]) >= self.n_fast]
        demote = [int(p) for p in demote if int(self.slot_of[p]) < self.n_fast]
        # zip stops at the shorter side: the remainder has no partner slot
        # in a full 1:1 layout. It is counted; the policy re-selects the
        # still-hot leftovers next epoch
        self.unpaired_promotes += max(len(promote) - len(demote), 0)
        self.unpaired_demotes += max(len(demote) - len(promote), 0)
        for pg_up, pg_down in zip(promote, demote):
            s_up = int(self.slot_of[pg_up])  # slow slot
            s_down = int(self.slot_of[pg_down])  # fast slot
            src.extend([s_up, s_down])
            dst.extend([s_down, s_up])
            self.slot_of[pg_up], self.slot_of[pg_down] = s_down, s_up
        if not src:
            return 0
        dev = self.pools.w_gate.device
        sidx = torch.as_tensor(src, dtype=torch.int32, device=dev)
        didx = torch.as_tensor(dst, dtype=torch.int32, device=dev)
        for pool in self.pools:  # in place
            ops.page_move(pool.view(self.n_slots, -1), sidx, didx)
        return len(src)

    # ------------------------------------------------------------- telemetry
    def fast_resident(self, layer: int, expert: int) -> bool:
        return int(self.slot_of[layer * self.cfg.num_experts + expert]) < self.n_fast

    def fmmr(self) -> float:
        return self.manager.fmmr_of(self.tenant)

    def fast_share_of_traffic(self, expert_counts) -> float:
        """Fraction of routed traffic hitting fast-resident experts."""
        flat = _host(expert_counts).astype(np.float64).reshape(-1)
        fast = self.slot_of < self.n_fast
        tot = flat.sum()
        return float(flat[fast].sum() / tot) if tot else 0.0


@torch.no_grad()
def moe_layer_from_pools(
    pools: ExpertPools,
    slots_l,  # [E] physical slots of this layer's experts (host tensor or array)
    router: torch.Tensor,  # [d, E] float32
    x: torch.Tensor,  # [T, d]
    cfg=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [T, d] in x's dtype, expert_counts [E] i32).

    Every assignment runs its expert densely (no capacity: serving decode
    batch sizes). The products run in the type JAX would promote the tokens
    and the weights to (float32 tokens with bf16 weights: float32). Only the
    routed experts are read, each through a view of its slot; the k choices
    are summed in order, as the reference adds them."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    _, gate_w, gate_ids = moe.gate(router, x, k)
    dt = torch.promote_types(x.dtype, pools.w_gate.dtype)
    xd, w = x.to(dt), gate_w.reshape(-1)
    flat = gate_ids.reshape(-1)
    counts = torch.bincount(flat, minlength=E).to(torch.int32)
    order = torch.sort(flat, stable=True).indices  # assignments grouped by expert
    slots = _host(slots_l).tolist()
    # weighting by the float32 gate promotes once more, as in the reference
    res = torch.empty((T * k, d), dtype=torch.promote_types(dt, w.dtype), device=x.device)
    lo = 0
    for e, n in enumerate(counts.tolist()):  # one host sync: which experts run
        if n == 0:
            continue
        a = order[lo : lo + n]
        lo += n
        s = slots[e]
        xt = xd[a // k]
        h = F.silu(xt @ pools.w_gate[s].to(dt)) * (xt @ pools.w_up[s].to(dt))
        res[a] = (h @ pools.w_down[s].to(dt)).to(res.dtype) * w[a, None]
    res = res.view(T, k, d)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + res[:, j].to(x.dtype)
    return out, counts
