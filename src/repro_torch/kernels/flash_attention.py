"""Wrapper of the CUDA causal GQA flash attention kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces the reference's Pallas kernel of the same name.
It takes CUDA tensors only, checks and launches as ``paged_attention.py``
does, and counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.paged_attention import check_aligned, check_tensor, dtype_code, typed_fn

LAUNCHES = {"flash_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0) -> torch.Tensor:
    """[B, nh, Sq, dh] causal GQA attention with suffix alignment (see
    ``ref.flash_attention_ref``). One launch: the Hopper kernel (TMA and
    wgmma) in bfloat16, the CUDA-core kernel in float32."""
    check_tensor("q", q, 4)
    dev, dt = q.device, q.dtype
    code = dtype_code(q)
    check_tensor("k", k, 4, dev, dt)
    check_tensor("v", v, 4, dev, dt)
    B, nh, Sq, dh = q.shape
    _, nkv, Skv, _ = k.shape
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != dh or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {dh}")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_aligned(name, t)  # the bf16 kernel's TMA maps need 16-byte bases
    fn = typed_fn("flash_attention", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, nh, nkv, Sq, Skv, dh,
        int(bool(causal)), int(sliding_window), 1.0 / math.sqrt(dh), code,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["flash_attention"] += 1
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
