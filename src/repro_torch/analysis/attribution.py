"""Per-operation cost attribution: which code a step's FLOPs and bytes come
from.

The reference walks compiled HLO and keys each contribution by its
instruction and its ``op_name`` metadata. The port counts one call with
``hlo_cost.CostCounter`` and keys each contribution by where it ran:
``comp`` (``forward`` or ``backward``), ``instr`` (the aten operation, or
the kernel's name), ``kind`` (the operation's name, or ``kernel``),
``op_name`` (the path of the port's functions on the stack, e.g.
``transformer.loss_fn/transformer.run_stack/transformer.block_full``; the
port's models are functions over parameter trees, not modules, so the
function path takes the place of a module path) and ``rtype`` (the
result's type, ``bf16[8,1024,2048]``). Repeated calls at one key (the
layers of a Python loop, the steps of a chunked loss) add up into one
contribution, as the reference multiplies an instruction by its loop's trip
count.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.hlo_cost import CostCounter


@dataclass
class Contribution:
    comp: str
    instr: str
    kind: str
    op_name: str
    flops: float
    bytes: float
    coll_bytes: float
    rtype: str = ""


def attribute(fn: Callable, *args, **kwargs) -> List[Contribution]:
    """The contributions of one call ``fn(*args, **kwargs)``, in the order
    each key first ran."""
    rows: Dict[Tuple[str, str, str, str], Contribution] = {}

    def on_op(comp, instr, kind, op_name, flops, nbytes, coll, rtype):
        op_name = op_name[-110:]
        key = (comp, instr, op_name, rtype)
        c = rows.get(key)
        if c is None:
            rows[key] = Contribution(comp, instr, kind, op_name, flops, nbytes, coll,
                                     rtype[:48])
        else:
            c.flops += flops
            c.bytes += nbytes
            c.coll_bytes += coll

    with CostCounter(on_op=on_op):
        fn(*args, **kwargs)
    return list(rows.values())


def top(contribs: List[Contribution], key: str = "bytes", n: int = 15):
    rows = sorted(contribs, key=lambda c: -getattr(c, key))[:n]
    total = sum(getattr(c, key) for c in contribs)
    print(f"--- top {n} by {key} (total {total:.3e}) ---")
    for c in rows:
        print(
            f"{getattr(c, key):>12.3e}  {c.kind:18s} {c.instr[:26]:28s} "
            f"{c.rtype:40s} {c.op_name[-70:]}"
        )
    return rows


# ---------------------------------------------------------------------------
# Kernel-adjusted memory term, as the reference's: an attention path that
# materialises score / probability tensors (shape [..., q_blk, kv_blk] and
# their stacked residuals) loses those contributions and gains a flash
# kernel's HBM traffic instead. A model, with the reference's mesh
# assumptions (a model axis of 16).
# ---------------------------------------------------------------------------
def kernel_adjusted_bytes(
    contribs: List[Contribution],
    cfg,
    shape,
    n_chips: int,
    q_blk: int = 512,
    kv_blk: int = 1024,
) -> Tuple[float, float]:
    """Returns (counted_bytes, kernel_adjusted_bytes) per device."""
    pat = re.compile(rf"\[(?:\d+,)*{q_blk},{kv_blk}\]")
    total = sum(c.bytes for c in contribs)
    attn_chain = sum(c.bytes for c in contribs if pat.search(c.rtype))
    # flash kernel HBM traffic per layer (bf16): fwd reads q,k,v + writes o;
    # bwd reads q,k,v,o,do + writes dq,dk,dv; remat re-reads q,k,v.
    B, S = shape.global_batch, shape.seq_len
    heads_local = max(cfg.num_heads // 16, 1)  # model axis 16
    kv_local = max(cfg.num_kv_heads // 16, 1)
    dh = cfg.d_head
    dp = n_chips // 16
    per_tensor_q = B * S * heads_local * dh * 2 / dp
    per_tensor_kv = B * S * kv_local * dh * 2 / dp
    fwd = 1 * per_tensor_q + 2 * per_tensor_kv + per_tensor_q  # q,k,v -> o
    bwd = 2 * per_tensor_q + 2 * per_tensor_kv + 2 * per_tensor_q + 3 * per_tensor_kv
    remat = fwd
    L_attn = cfg.attn_invocations if cfg.family == "hybrid" else cfg.num_layers
    kernel_traffic = (fwd + bwd + remat) * L_attn
    return total, total - attn_chain + kernel_traffic
