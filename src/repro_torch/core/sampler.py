"""PEBS-analogue access-stream sampling (paper §3.2).

The engine reports exact per-page access counts; they are subsampled with
p = 1/sample_period as Normal(np, np) rounded and clamped to [0, n], the
reference's cheap stand-in for Poisson(np). ``exact=True`` bypasses
sampling. The deviates come from a ``torch.Generator`` and cannot match the
reference's threefry stream; pass ``z`` to share deviates with it.

Float32 throughout, in the reference's order of operations: XLA on the CPU
contracts ``lam + sqrt(lam) * z`` into one fused multiply-add, so the port
evaluates it with :func:`fma_f32`. ``torch.round`` and ``jnp.round`` both
round half to even.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import MASK32


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with ONE rounding, as a fused multiply-add.

    The product of two float32 values is exact in float64; the sum is
    rounded to float64 and then to float32. That double rounding can differ
    from a single rounding only when the float64 sum lies exactly halfway
    between two float32 values; there the exact error of the float64 sum
    (TwoSum) decides the direction. Same arithmetic on the CPU and the card.
    """
    a64 = a.to(torch.float64)
    b64 = b.to(torch.float64) if isinstance(b, torch.Tensor) else float(np.float32(b))
    c64 = c.to(torch.float64)
    p = a64 * b64
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    tie = (s == (r64 + other.to(torch.float64)) * 0.5) & (err != 0)
    fixed = torch.where(err > 0, torch.maximum(r, other), torch.minimum(r, other))
    return torch.where(tie, fixed, r)


def sample_accesses(
    rng: Optional[torch.Generator],
    counts: torch.Tensor,  # i64[P] (u32 values) exact accesses this epoch
    sample_period,  # int, or a 0-d integer tensor (one machine of a fleet)
    *,
    exact: bool = False,
    z: Optional[torch.Tensor] = None,  # optional pre-drawn f32[P] deviates
) -> torch.Tensor:
    """Returns i64[P] sampled access counts (u32 values)."""
    counts = counts.to(torch.int64) & MASK32
    if exact:
        return counts.clone()
    if isinstance(sample_period, torch.Tensor):
        period = sample_period.to(torch.float32)
        p = torch.reciprocal(torch.clamp(period, min=1.0))
    else:
        period = np.float32(sample_period)
        p = float(np.float32(1.0) / np.maximum(period, np.float32(1.0)))
    n = counts.to(torch.float32)
    lam = n * p
    if z is None:
        z = torch.randn(lam.shape, generator=rng, dtype=torch.float32, device=lam.device)
    z = z.to(device=lam.device, dtype=torch.float32)
    draw = torch.round(fma_f32(torch.sqrt(lam), z, lam))
    draw = torch.minimum(torch.clamp(draw, min=0.0), n)
    # f32 -> u32 saturates at the top of the range (an n rounded up to 2^32)
    sampled = torch.clamp(draw.to(torch.int64), max=MASK32)
    if isinstance(period, torch.Tensor):
        return torch.where(period <= 1.0, counts, sampled)
    if period <= 1.0:
        return counts.clone()
    return sampled
