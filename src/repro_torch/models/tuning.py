"""Implementation and schedule flags, the port's copy of the reference's
``models/tuning.py``.

A process-global mutable record read by the model code at call time (the
reference reads it at trace time). ``tuned(**flags)`` sets flags for a
block and restores them after. The defaults are the reference's.

This is deliberately not part of ``ModelConfig``: architecture configs are
published facts; these are implementation choices.

The port reads ``attn_score_f32``, ``q_block``, ``kv_block``,
``decode_deferred_commit``, ``loss_logits_bf16``, ``norm_bf16_apply``,
``capacity_factor`` and ``ssd_chunk`` (``models/ssm.ssd_chunk``). The
sharding flags act under a device mesh (``launch.partitioning.
use_partitioning``) and change nothing on plain tensors:
  * ``seq_parallel_activations``: ``models/transformer.block_full`` shards
    the residual stream over "model" between the layers of a model without
    MoE;
  * ``moe_shardmap``: ``models/moe.moe_mlp`` runs ``moe_mlp_shardmap``;
  * ``moe_explicit_a2a``: ``models/moe.moe_mlp`` lays its dispatch buffer
    out token-local, then expert-parallel (two ``shard`` steps);
  * ``moe_shard_capacity``, ``moe_shard_both``, ``serve_resident_weights``:
    ``launch/shardings.rules_for`` (the dispatch buffer's axes; decode cells'
    weights off the data axes).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass
class TuningFlags:
    # attention: dtype of the score / probability tensors of the blocked
    # (training) attention. fp32 = baseline.
    attn_score_f32: bool = True
    # block sizes of the blocked attention
    q_block: int = 512
    kv_block: int = 1024
    # sharding flags (under a device mesh; see the module docstring)
    seq_parallel_activations: bool = True
    moe_shard_capacity: bool = False
    moe_shard_both: bool = False
    moe_explicit_a2a: bool = False
    moe_shardmap: bool = True
    # decode: attention reads the cache as it was before the step and merges
    # the current token's key and value exactly (online-softmax stats); the
    # new keys and values of every layer are committed once after the stack
    decode_deferred_commit: bool = True
    # serving: replicate weights across the data axes (a sharding flag)
    serve_resident_weights: bool = True
    # MoE capacity factor override (None: the config's)
    capacity_factor: Optional[float] = None
    # chunked CE loss: logits in bf16 (False = fp32 baseline)
    loss_logits_bf16: bool = False
    # SSD chunk length override (0 = cfg.ssm_chunk)
    ssd_chunk: int = 0
    # rms_norm: float32 only for the variance and the [B, S, 1] scale; the
    # full-width multiply stays in the compute dtype. Baseline: full fp32.
    norm_bf16_apply: bool = False


FLAGS = TuningFlags()  # one shared object, mutated in place


@contextlib.contextmanager
def tuned(**kw):
    prev = {k: getattr(FLAGS, k) for k in kw}
    for k, v in kw.items():
        setattr(FLAGS, k, v)
    try:
        yield FLAGS
    finally:
        for k, v in prev.items():
            setattr(FLAGS, k, v)
