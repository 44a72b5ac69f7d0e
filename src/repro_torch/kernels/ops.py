"""Public kernel entry points, dispatched by the tensor's device only.

A CUDA tensor launches the hand-written kernel (or raises: a missing nvcc,
a failed build and a failed launch all surface as exceptions). A CPU tensor
takes the plain PyTorch version in ``ref.py``. There is no environment
override and no fallback from one to the other.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hot_bins as _hb
from repro_torch.kernels import page_copy as _pc
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def hot_bins(page_ids: torch.Tensor, counts_in: torch.Tensor, *, num_bins: int = 6):
    """(counts_out i32[P], bins i32[P]); see ``ref.hot_bins_ref``."""
    if _on_cuda(counts_in):
        return _hb.hot_bins(page_ids, counts_in, num_bins=num_bins)
    return ref.hot_bins_ref(page_ids, counts_in, num_bins)


def page_copy(src_pool, dst_pool, src_ids, dst_ids):
    """In place ``dst_pool[dst_ids] = src_pool[src_ids]``; returns dst_pool."""
    if _on_cuda(dst_pool):
        return _pc.page_copy(src_pool, dst_pool, src_ids, dst_ids)
    return ref.page_copy_ref(src_pool, dst_pool, src_ids, dst_ids)


def page_move(pool, src_ids, dst_ids):
    """In place intra-pool moves with gather semantics; returns pool."""
    if _on_cuda(pool):
        return _pc.page_move(pool, src_ids, dst_ids)
    return ref.page_move_ref(pool, src_ids, dst_ids)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """[B, nh, dh] one-token decode attention over a block table of pages;
    see ``ref.paged_attention_ref``."""
    if _on_cuda(q):
        return _pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens)
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """[B, nh, Sq, dh] causal GQA attention with suffix alignment; see
    ``ref.flash_attention_ref``."""
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, causal=causal, sliding_window=sliding_window)
    return ref.flash_attention_ref(q, k, v, causal=causal, sliding_window=sliding_window)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {**_pc.LAUNCHES, **_hb.LAUNCHES, **_pa.LAUNCHES, **_fa.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_pc.LAUNCHES, _hb.LAUNCHES, _pa.LAUNCHES, _fa.LAUNCHES):
        for name in counts:
            counts[name] = 0
