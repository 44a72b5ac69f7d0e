"""Carry the reference's weights across: the JAX package's param pytree, as
the numpy arrays of ``jax.device_get``, into the port's parameters.

The two packages share one layout (dense weights [in, out], every layer's
weights stacked on leading axes), so the conversion is a copy with the
config's dtype. The trees, by family:
- dense / MoE / VLM: ``embed``, ``layers`` (``attn_norm``, ``attn`` with
  ``w_q``, ``w_k``, ``w_v``, ``w_o`` and the optional biases and qk-norms,
  ``mlp_norm``, ``mlp`` or, for an MoE config, ``moe``), ``final_norm`` and
  ``lm_head`` unless the embeddings are tied. The MoE subtree is ``router``
  [L, d, E], ``w_gate``, ``w_up`` and ``w_down`` [L, Ep, ...] with the pad
  experts, and the optional ``shared`` block;
- SSM: ``embed``, ``layers`` (``norm``, ``ssm``), ``final_norm``;
- hybrid: ``embed``, ``mamba_groups`` [G, per_group, ...], ``mamba_tail``
  [tail, ...] where the layout has a tail, ``shared_attn``, ``final_norm``;
- audio: ``embed``, ``enc_layers``, ``enc_norm``, ``dec_layers``,
  ``final_norm`` (LayerNorms as ``w`` and ``b``).
``router``, ``A_log``, ``D`` and ``dt_bias`` stay float32 whatever the
param dtype, as the reference keeps them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.moe import padded_experts


def tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    """One array as a tensor of ``dtype`` on ``device``. A bfloat16 array
    (numpy's ``ml_dtypes`` extension type, which torch cannot read) is
    reinterpreted bit for bit through uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a copy: device_get arrays are read-only
    return t.to(device=device, dtype=dtype)


FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias")


def expected_keys(cfg) -> set:
    """The top-level keys of ``cfg``'s param tree."""
    head = set() if cfg.tie_embeddings else {"lm_head"}
    if cfg.family == "ssm":
        return {"embed", "layers", "final_norm"} | head
    if cfg.family == "hybrid":
        tail = cfg.num_layers - cfg.attn_invocations * cfg.attn_every
        return ({"embed", "mamba_groups", "shared_attn", "final_norm"}
                | ({"mamba_tail"} if tail else set()) | head)
    if cfg.family == "audio":
        return {"embed", "enc_layers", "enc_norm", "dec_layers", "final_norm"}
    return {"embed", "layers", "final_norm"} | head


def params_from_numpy(cfg, params_np: Dict[str, Any], device, dtype=None) -> Dict[str, Any]:
    """The port's parameter tree from the reference's (numpy leaves). Every
    leaf takes ``dtype`` where given (the optimizer's float32 moments and the
    error buffer of grad compression share the tree), else the config's."""
    expected = expected_keys(cfg)
    if set(params_np) != expected:
        raise KeyError(f"param tree has {sorted(params_np)}, expected {sorted(expected)}")

    def conv(tree, name=""):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        if dtype is not None:
            return tensor_from_numpy(tree, dtype, device)
        return tensor_from_numpy(tree, torch.float32 if name in FLOAT32_LEAVES else cfg.pdtype,
                                 device)

    out = conv(params_np)
    if cfg.family in ("dense", "moe", "vlm"):
        _check_transformer(cfg, out)
    return out


def _check_transformer(cfg, out) -> None:
    L = cfg.num_layers
    for name, leaf in out["layers"]["attn"].items():
        if leaf.shape[0] != L:
            raise ValueError(f"layers.attn.{name} has no leading layer axis of {L}")
    if cfg.is_moe:
        moe = out["layers"].get("moe")
        if moe is None:
            raise KeyError("an MoE config's layers need a moe subtree")
        lead = {"router": (L, cfg.d_model, cfg.num_experts)}
        lead.update({w: (L, padded_experts(cfg)) for w in ("w_gate", "w_up", "w_down")})
        for name, shape in lead.items():
            if tuple(moe[name].shape[: len(shape)]) != shape:
                raise ValueError(f"layers.moe.{name} has shape {tuple(moe[name].shape)}, "
                                 f"expected leading axes {shape}")
        if ("shared" in moe) != bool(cfg.num_shared_experts):
            raise KeyError("layers.moe.shared must be present iff the config has shared experts")
        for name, leaf in moe.get("shared", {}).items():
            if leaf.shape[0] != L:
                raise ValueError(f"layers.moe.shared.{name} has no leading layer axis of {L}")
