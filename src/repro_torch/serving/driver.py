"""Open-loop multi-tenant serving driver (the reference's
``serving/driver.py``, unchanged in behaviour; host numpy).

Arrivals are open-loop: each tenant submits new requests at a Poisson rate
per decode step, independent of how loaded the engine is — the shape under
which admission backpressure and tail latency actually mean something (a
closed loop self-throttles and hides both; TPP/the paper's Fig. 5-7 are
open-loop for the same reason). The arrival stream is drawn from its own
RNG, so two engines driven with the same seed and specs see the SAME
request sequence — placement policy is the only difference between
benchmark legs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.engine import ServingEngine


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One open-loop tenant: LS tenants run tight ``t_miss`` targets and
    lower arrival rates; BE co-runners run ``t_miss`` ~ 1.0 and flood."""

    name: str
    t_miss: float
    arrival_rate: float  # expected new requests per decode step
    prompt_tokens: int
    max_new_tokens: int


class OpenLoopDriver:
    def __init__(self, engine: ServingEngine, tenants: Sequence[TenantSpec],
                 seed: int = 0):
        self.engine = engine
        self.tenants = list(tenants)
        self.rng = np.random.default_rng(seed)
        # a fixed-partition manager's quotas are named by tenant: resolve them
        # onto the handles as the tenants register
        named = getattr(engine.manager, "named_quota", {})
        for t in self.tenants:
            engine.add_tenant(t.name, t.t_miss)
            if t.name in named:
                engine.manager.fast_quota[int(engine.tenant_handles[t.name])] = named[t.name]
        self.submitted: Dict[str, int] = {t.name: 0 for t in self.tenants}
        self.steps_run = 0

    def run(self, n_steps: int) -> Dict[str, dict]:
        """Drive ``n_steps`` decode steps (callable repeatedly — e.g. a
        warmup segment then a timed segment); the report always covers the
        whole run so far."""
        eng = self.engine
        for _ in range(n_steps):
            for t in self.tenants:
                for _ in range(int(self.rng.poisson(t.arrival_rate))):
                    prompt = self.rng.integers(
                        1, eng.cfg.vocab_size, t.prompt_tokens
                    )
                    eng.submit(t.name, prompt, t.max_new_tokens)
                    self.submitted[t.name] += 1
            eng.step()
        self.steps_run += n_steps
        return self.report(self.steps_run)

    def report(self, n_steps: int) -> Dict[str, dict]:
        eng = self.engine
        out: Dict[str, dict] = {}
        for t in self.tenants:
            done = [r for r in eng.finished if r.tenant == t.name]
            active = [
                r for r in eng.lanes if r is not None and r.tenant == t.name
            ]
            tokens = sum(len(r.generated) for r in done + active)
            delays: List[int] = [r.queue_delay_steps for r in done]
            out[t.name] = {
                "latency": eng.latency_percentiles(t.name),
                "submitted": self.submitted[t.name],
                "completed": len(done),
                "generated_tokens": tokens,
                "tokens_per_step": tokens / max(n_steps, 1),
                "queue_delay_mean_steps": float(np.mean(delays)) if delays else 0.0,
                "queue_delay_max_steps": int(np.max(delays)) if delays else 0,
            }
        out["_engine"] = {
            "steps": n_steps,
            "migrated_pages": eng._migrated_pages,
            "migrated_bytes": eng.migrated_bytes,
            "admission_blocked": eng.admission_blocked,
            "queue_depth_end": len(eng.queue),
        }
        return out
