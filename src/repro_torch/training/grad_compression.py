"""Int8 gradient compression with error feedback, the reference's
``training/grad_compression.py``.

Each gradient leaf is quantised to int8 with a per-tensor scale and
dequantised again; the quantisation residual is carried in an error-feedback
buffer and added back next step (Seide et al. / 1-bit Adam lineage).
Rounding is half to even in both packages (``jnp.round``, ``torch.round``).

``shardmap_int8_psum``, the reference's int8-wire all-reduce over a device
mesh, waits for the mesh tooling (ROADMAP Queue 1 item 11): it raises.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import tree_map


def _quant(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / torch.full(
        (), 127.0, dtype=g.dtype, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, error_buf: Any) -> Tuple[Any, Any]:
    """Quantise + dequantise each grad leaf with error feedback. Returns
    (dequantised grads in each leaf's dtype, new error buffer in float32)."""

    def one(g, e):
        gf = g.float() + e
        q, scale = _quant(gf)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, error_buf)
    return (tree_map(lambda g, t: t[0], grads, out), tree_map(lambda g, t: t[1], grads, out))


def init_error_buf(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def shardmap_int8_psum(mesh, axis_names):
    raise NotImplementedError(
        "the int8-wire all-reduce needs a device mesh: it waits for ROADMAP Queue 1 item 11"
    )
