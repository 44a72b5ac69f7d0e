"""Integer prefix sums for million-page geometries.

The reference tiles long cumsums into blocks because XLA:CPU's single-axis
scan grows far worse than linearly with its length. ``torch.cumsum`` is one
linear scan on both the CPU and the card, and integer addition is exact and
associative, so the port computes the same values with one call. The one
thing to watch is the result type: ``torch.cumsum`` promotes int32 (and
bool) to int64 unless it is given ``dtype=``; here the result keeps the
input's integer type, as ``jnp.cumsum`` does.
"""
from __future__ import annotations

import torch


def tiled_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jnp.cumsum(x, axis)`` with the input's dtype (bool sums as int64)."""
    dtype = torch.int64 if x.dtype == torch.bool else x.dtype
    return torch.cumsum(x, dim=axis, dtype=dtype)
