"""Public kernel entry points, dispatched by the tensor's device only.

A CUDA tensor launches the hand-written kernel (or raises: a missing nvcc,
a failed build and a failed launch all surface as exceptions). A CPU tensor
takes the plain PyTorch version in ``ref.py``. There is no environment
override and no fallback from one to the other.

Cost counting (``repro_torch.analysis.hlo_cost``): while a cost counter
is on the dispatch-mode stack, each entry point reports its kernel's
analytic FLOPs and HBM bytes, computed from its shapes (and, where the work
depends on the data, from these inputs) by the ``*_cost`` functions below,
and the counter ignores the operations inside the call. A counted call
therefore reads the same whichever implementation runs: the CUDA kernel,
launched through ctypes where no dispatch mode sees it, or the plain
version's step-by-step arithmetic. The counter is found on the mode stack,
which the autograd engine carries to the thread that runs a backward, so an
entry point called inside a backward is counted on the card as on the CPU.
A fake tensor (``FakeTensorMode``, the dry-run) takes the plain version,
whose operations on fake tensors compute shapes and nothing else; under a
counter the call reads its kernel's analytic cost all the same.

Memory (``repro_torch.analysis.memory``): under the counter each entry
point also reports what its kernel holds on the card beyond its operands
and its new outputs, which the counter follows as they are: the bytes the
``*_workspace`` functions below give, allocated (> 0) and freed (< 0) in
order; an entry point with none holds nothing more. The plain versions'
temporaries do not show, so a call reads the same on the card, on the CPU
and on fake tensors.

Under a device mesh (``launch/partitioning.py``), ``flash_attention`` and
``paged_attention`` take ``DTensor`` inputs: the kernel runs on each rank's
local shards wherever its math is independent along the sharded dimension
(lanes over the batch, heads over the heads), and the result is wrapped
back as a ``DTensor``. Any other placement (a sharded sequence, a partial
sum) is first redistributed explicitly to one the kernel takes, which the
cost counter sees as a collective; nothing switches to the plain version.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hot_bins as _hb
from repro_torch.kernels import page_copy as _pc
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.launch.partitioning import attention_on_shards


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def _cost_sink():
    """The innermost cost counter on the dispatch-mode stack (a mode with
    ``counts_kernels`` set and ``kernel(name, cost, launch, workspace,
    operands)``, which calls ``cost()`` -> (flops, bytes), ``workspace()``
    -> bytes allocated and freed and ``launch()`` with its own counting
    suspended and returns what ``launch`` returns), or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "counts_kernels", False):
            return mode
    return None


def _run(name: str, on: torch.Tensor, kernel: Callable, plain: Callable,
         cost: Callable[..., Tuple[float, float]], *args,
         workspace: Optional[Callable[..., List[int]]] = None, **kw):
    """``kernel(*args, **kw)`` when ``on`` lies on the card, else
    ``plain(*args, **kw)``; under a cost counter, reported as one call of
    ``name`` costing ``cost(*args, **kw)`` and holding
    ``workspace(*args, **kw)`` (None: nothing)."""
    fn = plain if is_fake(on) else (kernel if _on_cuda(on) else plain)
    sink = _cost_sink()
    if sink is None:
        return fn(*args, **kw)
    return sink.kernel(name, lambda: cost(*args, **kw), lambda: fn(*args, **kw),
                       lambda: [] if workspace is None else workspace(*args, **kw), args)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def hot_bins_cost(page_ids, counts_in, num_bins: int = 6) -> Tuple[float, float]:
    """No floating-point work; the ids read, the counts read and written and
    the bins written."""
    return 0.0, float(_nbytes(page_ids) + 3 * counts_in.numel() * 4)


def page_copy_cost(src_pool, dst_pool, src_ids, dst_ids) -> Tuple[float, float]:
    """Every entry's row read and written (padding entries write the trash
    row), and the ids."""
    row = dst_pool[0].numel() * dst_pool.element_size()
    return 0.0, float(2 * src_ids.numel() * row + _nbytes(src_ids) + _nbytes(dst_ids))


def page_move_cost(pool, src_ids, dst_ids) -> Tuple[float, float]:
    """The real entries' rows (ids that differ, both in range) read and
    written once, and the ids."""
    rows = pool.shape[0]
    # on the host, so that counting allocates nothing on the card
    s, d = src_ids.cpu().to(torch.int64), dst_ids.cpu().to(torch.int64)
    real = int(((s != d) & (s >= 0) & (s < rows) & (d >= 0) & (d < rows)).sum())
    row = pool[0].numel() * pool.element_size()
    return 0.0, float(2 * real * row + _nbytes(src_ids) + _nbytes(dst_ids))


def paged_attention_cost(q, k_pages, v_pages, block_tables, seq_lens) -> Tuple[float, float]:
    """4 nh dh flops a valid key (scores and the product with V); the valid
    K and V rows of each lane's pages, q, the output, tables and lengths."""
    B, nh, dh = q.shape
    page, nkv = k_pages.shape[1], k_pages.shape[2]
    t, n = block_tables.cpu().numpy(), seq_lens.cpu().numpy().astype(np.int64)
    p = np.arange(t.shape[1])[None, :]
    valid = int((np.clip(n[:, None] - p * page, 0, page) * (t >= 0)).sum())
    nbytes = (2 * valid * nkv * dh * k_pages.element_size() + 2 * _nbytes(q)
              + _nbytes(block_tables) + _nbytes(seq_lens))
    return 4.0 * nh * dh * valid, float(nbytes)


def attention_pairs(Sq: int, Skv: int, causal: bool, sliding_window: int) -> int:
    """(query, key) pairs the masks of ``ref.flash_attention_ref`` keep:
    queries at positions Skv - Sq + i, keys at or before them when causal,
    within the last ``sliding_window`` positions when one is set."""
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1, np.int64)
    lo = np.maximum(pos - sliding_window + 1, 0) if sliding_window else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_cost(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0) -> Tuple[float, float]:
    """4 dh flops a kept (query, key) pair and head (QK^T and PV); q, k, v
    read and the output written once."""
    B, nh, Sq, dh = q.shape
    pairs = attention_pairs(Sq, k.shape[2], causal, sliding_window)
    return 4.0 * B * nh * dh * pairs, float(2 * _nbytes(q) + _nbytes(k) + _nbytes(v))


def page_move_workspace(pool, src_ids, dst_ids) -> List[int]:
    """The growth of the per-device workspace on the card, kept after the
    call (``page_copy.workspace_growth``); nothing on the CPU or on fake
    tensors, where the plain version keeps none."""
    if is_fake(pool) or not _on_cuda(pool):
        return []
    return _pc.workspace_growth(pool.device, pool.shape[0], src_ids.shape[0],
                                pool.shape[1] * pool.element_size())


def paged_attention_workspace(q, k_pages, v_pages, block_tables, seq_lens) -> List[int]:
    """The float32 split-K partials (``paged_attention.split_partials``),
    during the call only; their split count from the card's SMs, or the
    H100's where the call does not run on a card (the CPU, fake tensors)."""
    B, nh, dh = q.shape
    if not is_fake(q) and _on_cuda(q):
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    else:
        sms = _pa.H100_SMS
    part = 4 * _pa.split_partials(B, nh, k_pages.shape[2], dh, block_tables.shape[1], sms)[3]
    return [part, -part]


def hot_bins(page_ids: torch.Tensor, counts_in: torch.Tensor, *, num_bins: int = 6):
    """(counts_out i32[P], bins i32[P]); see ``ref.hot_bins_ref``."""
    return _run("hot_bins", counts_in, _hb.hot_bins, ref.hot_bins_ref, hot_bins_cost,
                page_ids, counts_in, num_bins=num_bins)


def page_copy(src_pool, dst_pool, src_ids, dst_ids):
    """In place ``dst_pool[dst_ids] = src_pool[src_ids]``; returns dst_pool."""
    return _run("page_copy", dst_pool, _pc.page_copy, ref.page_copy_ref, page_copy_cost,
                src_pool, dst_pool, src_ids, dst_ids)


def page_move(pool, src_ids, dst_ids):
    """In place intra-pool moves with gather semantics; returns pool."""
    return _run("page_move", pool, _pc.page_move, ref.page_move_ref, page_move_cost,
                pool, src_ids, dst_ids, workspace=page_move_workspace)


def _any_dtensor(*ts) -> bool:
    return any(isinstance(t, DTensor) for t in ts)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """[B, nh, dh] one-token decode attention over a block table of pages;
    see ``ref.paged_attention_ref``. ``DTensor`` inputs run shard by shard
    (``partitioning.attention_on_shards``: lanes with their tables and lengths, heads with the
    pools' kv heads)."""
    if _any_dtensor(q, k_pages, v_pages, block_tables, seq_lens):
        def call(*ts):
            return paged_attention(*(t.contiguous() for t in ts))

        return attention_on_shards(call, q, (k_pages, v_pages), (block_tables, seq_lens),
                                   q_heads=1, kv_heads=2, kv_batch=None)
    return _run("paged_attention", q, _pa.paged_attention, ref.paged_attention_ref,
                paged_attention_cost, q, k_pages, v_pages, block_tables, seq_lens,
                workspace=paged_attention_workspace)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """[B, nh, Sq, dh] causal GQA attention with suffix alignment; see
    ``ref.flash_attention_ref``. ``DTensor`` inputs run shard by shard
    (``partitioning.attention_on_shards``: lanes and heads; a sharded sequence is gathered
    first)."""
    if _any_dtensor(q, k, v):
        def call(q, k, v):
            return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, sliding_window=sliding_window)

        return attention_on_shards(call, q, (k, v), (), q_heads=1, kv_heads=1, kv_batch=0)
    return _run("flash_attention", q, _fa.flash_attention, ref.flash_attention_ref,
                flash_attention_cost, q, k, v, causal=causal, sliding_window=sliding_window)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {**_pc.LAUNCHES, **_hb.LAUNCHES, **_pa.LAUNCHES, **_fa.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_pc.LAUNCHES, _hb.LAUNCHES, _pa.LAUNCHES, _fa.LAUNCHES):
        for name in counts:
            counts[name] = 0
