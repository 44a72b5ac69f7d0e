"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

``paged_attention`` replaces the reference's Pallas kernel of the same name.
It takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates its output with ``torch.empty``, launches on the current stream,
raises if the launch failed, and counts its launches in ``LAUNCHES``.
``kernels/ops.py`` sends CPU tensors to the plain version in
``kernels/ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"paged_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def typed_fn(name: str, argtypes):
    """The C function ``name`` of ``csrc/<name>.cu``, built at first use."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
        lib._typed = True
    return getattr(lib, name)


def check_tensor(name: str, t: torch.Tensor, dim: int, device=None, dtype=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"no attention kernel for {t.dtype}; float32 and bfloat16 only")
    return _DTYPE_CODE[t.dtype]


HEAD_DIMS = (16, 32, 64, 128)
WARPS = 4  # warps of a split CTA (csrc/paged_attention.cu kWarps)
CTAS_PER_SM = 4


def split_plan(B: int, nkv: int, n_p: int, sms: int) -> tuple:
    """(n_split, per): each (lane, KV head) pair gets ``n_split`` CTAs over
    contiguous splits of ``per`` table entries, enough for about
    ``CTAS_PER_SM`` CTAs on each of ``sms`` SMs. A split longer than one
    entry per warp is rounded up to a whole number of entries per warp, and
    no split is empty. At the yi-6b serving shape (32 lanes, 4 KV heads, 32
    entries, 132 SMs) that is 4 splits of 8 entries: 512 CTAs."""
    if n_p <= 0:
        return 1, 1
    want = max(1, -(-CTAS_PER_SM * sms // max(B * nkv, 1)))
    per = -(-n_p // min(want, n_p))
    if per > WARPS:
        per = -(-per // WARPS) * WARPS
    return -(-n_p // per), per


def team_fits(dh: int, itemsize: int, g: int) -> bool:
    """Whether the kernel's lanes can carry a group of ``g`` query heads: a
    team of lanes covers one dh row in 16-byte vectors, a warp's teams
    share out the heads, and a team reduces at most min(8, its lanes) of
    them (rounded up to a power of two)."""
    lanes = dh // (16 // itemsize)
    per_team = -(-g // (32 // lanes))
    return 1 << (per_team - 1).bit_length() <= min(8, lanes)


H100_SMS = 132  # the SMs a plan assumes for a call that runs on no card


def split_partials(B: int, nh: int, nkv: int, dh: int, n_p: int, sms: int) -> tuple:
    """(n_split, per, n_acc, floats) of a call shape on ``sms`` SMs: the
    split plan (``split_plan``) and its f32 partials, ``floats`` in one
    buffer: acc [B, nkv, n_split, g, dh] (``n_acc``), then (m, l)
    [B, nkv, n_split, g, 2]."""
    n_split, per = split_plan(B, nkv, n_p, sms)
    n_acc = B * nh * n_split * dh
    return n_split, per, n_acc, n_acc + n_acc // dh * 2


_PLANS: dict = {}


def _plan(dev: torch.device, B: int, nh: int, nkv: int, dh: int, itemsize: int, n_p: int):
    """``split_partials`` of a call shape on the card, worked out once per
    shape and device: a decode step makes the same call in every layer."""
    key = (dev.index, B, nh, nkv, dh, itemsize, n_p)
    plan = _PLANS.get(key)
    if plan is None:
        g = nh // nkv
        if not team_fits(dh, itemsize, g):
            raise ValueError(f"paged_attention: {g} query heads per KV head is too many at dh {dh}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = _PLANS[key] = split_partials(B, nh, nkv, dh, n_p, sms)
    return plan


def check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens) -> torch.Tensor:
    """[B, nh, dh] decode attention of q over the pages of ``block_tables``
    (see ``ref.paged_attention_ref``). One call: the split kernel, then the
    kernel that merges the splits (``ref.paged_attention_split_ref`` is its
    plain model)."""
    check_tensor("q", q, 3)
    dev, dt = q.device, q.dtype
    code = dtype_code(q)
    check_tensor("k_pages", k_pages, 4, dev, dt)
    check_tensor("v_pages", v_pages, 4, dev, dt)
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must have the same shape")
    B, nh, dh = q.shape
    _, page, nkv, dh_k = k_pages.shape
    if dh_k != dh or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention takes head dims {HEAD_DIMS}, got {dh}")
    check_tensor("block_tables", block_tables, 2, dev, torch.int32)
    check_tensor("seq_lens", seq_lens, 1, dev, torch.int32)
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables and seq_lens need one row per query")
    q_ptr, k_ptr, v_ptr = q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()
    if (q_ptr | k_ptr | v_ptr) % 16:
        raise ValueError("q, k_pages and v_pages must start on 16-byte boundaries")
    n_p = block_tables.shape[1]
    n_split, per, n_acc, floats = _plan(dev, B, nh, nkv, dh, q.element_size(), n_p)
    out = torch.empty_like(q)
    part = torch.empty(floats, dtype=torch.float32, device=dev)
    fn = typed_fn("paged_attention", [_P] * 8 + [_I] * 8 + [_F, _I, _P])
    err = fn(
        q_ptr, k_ptr, v_ptr, block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), part.data_ptr() + 4 * n_acc, B, n_p, per, n_split, page, nkv, dh,
        nh // nkv, 1.0 / math.sqrt(dh), code, torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["paged_attention"] += 1
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
