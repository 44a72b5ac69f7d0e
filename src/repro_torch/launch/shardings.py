"""Per-architecture sharding rules and the input / cache / state sharding
builders, the reference's ``launch/shardings.py`` on a ``DeviceMesh``.

Rules adapt to the mesh's model-axis size: logical axes whose dimension does
not divide the axis fall back to replication (or to sequence sharding for KV
caches), per DESIGN.md §5. Everything downstream (parameter, cache and batch
shardings) derives from the one rules dict. Axis sizes are read with
``mesh.size(mesh.mesh_dim_names.index(name))`` (``launch.mesh.axis_size``),
so a ``DeviceMesh`` and a device-free ``launch.mesh.MeshShape`` both serve.

The sharding flags of ``models/tuning.py`` are read here as the reference
reads them: ``serve_resident_weights`` (decode cells keep the weights off
the data axes), ``moe_shard_both`` and ``moe_shard_capacity`` (the MoE
dispatch buffer's layout).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.launch.mesh import axis_size
from repro_torch.launch.partitioning import (
    NamedSharding,
    PartitionSpec as P,
    default_rules,
    logical_spec,
    param_specs,
)
from repro_torch.models import tuning
from repro_torch.models.encdec import EncDecCache
from repro_torch.models.hybrid import HybridCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.ssm_lm import SSMLMCache
from repro_torch.models.transformer import KVCache


def rules_for(cfg, mesh, shape=None) -> Dict[str, Any]:
    multi_pod = "pod" in mesh.mesh_dim_names
    r = default_rules(multi_pod)
    m = axis_size(mesh, "model")
    dp = r["batch"]
    dp_size = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        dp_size *= axis_size(mesh, a)
    if shape is not None and shape.global_batch % dp_size != 0:
        # e.g. long_500k (B=1): batch replicated; KV sequence carries memory
        r["batch"] = None
        r["kv_seq"] = ("model",)

    # big embeddings also shard their d_model dim over the data axes (FSDP)
    r["fsdp_embed"] = dp if cfg.vocab_size * cfg.d_model > 5e7 else None

    if shape is not None and shape.is_decode and tuning.FLAGS.serve_resident_weights:
        # inference layout: no optimizer state, weights replicated over the
        # data axes (TP-sharded only) => zero per-step FSDP gathers
        r["fsdp"] = None
        r["fsdp_embed"] = None

    def divides(n):
        return n > 0 and n % m == 0

    if not divides(cfg.num_heads):
        # uneven head sharding; replicate only tiny models
        r["heads"] = ("model",) if cfg.num_heads >= m else None
    if not divides(cfg.num_kv_heads):
        r["kv_heads"] = None
        # shard decode KV over sequence instead (flash-decoding split-K)
        r["kv_seq"] = ("model",)
    if not divides(cfg.d_ff):
        r["d_ff"] = None
    if cfg.vocab_size % m:
        r["vocab"] = ("model",) if cfg.vocab_size > 100_000 else None
    if cfg.is_moe and tuning.FLAGS.moe_shard_both:
        r["experts_buf"] = ("model",)
        r["expert_cap"] = dp
    elif cfg.is_moe and tuning.FLAGS.moe_shard_capacity:
        # keep the dispatch buffer token-sharded (the scatter stays local)
        r["experts_buf"] = None
        r["expert_cap"] = dp
    if cfg.ssm_state:
        r["ssm_heads"] = ("model",) if divides(cfg.ssm_heads) else None
        # the packed in_proj dim is not TP-shardable (slice boundaries
        # misalign); SSM weights stay FSDP-only (DESIGN.md §5)
        r["ssm_inner"] = None
    return r


# --------------------------------------------------------------------------- specs
def batch_specs(cfg, shape, mesh, rules) -> Dict[str, NamedSharding]:
    def mk(*names):
        return NamedSharding(mesh, logical_spec(names, rules))

    if shape.is_decode:
        return {"token": mk("batch")}
    specs = {"tokens": mk("batch", "seq"), "labels": mk("batch", "seq")}
    if cfg.is_encoder_decoder:
        specs["enc_embeds"] = mk("batch", "enc_seq", None)
    return specs


def _named(specs, mesh):
    if isinstance(specs, dict):
        return {k: _named(v, mesh) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def params_sharding(params, mesh, rules):
    """A ``NamedSharding`` tree for a parameter tree (tensors, meta or fake
    tensors, or anything with a ``shape``)."""
    return _named(param_specs(params, rules), mesh)


def cache_sharding(cache, cfg, mesh, rules):
    """``NamedSharding`` tree for a decode cache (family-specific layouts);
    ``pos`` (a Python int in the port) gets the replicated spec, as the
    reference's [] int32."""
    def mk(*names):
        return NamedSharding(mesh, logical_spec(names, rules))

    rep = mk()
    kv5 = mk(None, "batch", "kv_seq", "kv_heads", None)  # [L, B, S, h, dh]
    if isinstance(cache, KVCache):
        return KVCache(k=kv5, v=kv5, pos=rep)
    if isinstance(cache, SSMLMCache):
        return SSMLMCache(
            layers=SSMCache(conv=mk(None, "batch", None, None),
                            state=mk(None, "batch", "ssm_heads", None, None)),
            pos=rep)
    if isinstance(cache, HybridCache):
        return HybridCache(
            group_ssm=SSMCache(conv=mk(None, None, "batch", None, None),
                               state=mk(None, None, "batch", "ssm_heads", None, None)),
            tail_ssm=SSMCache(conv=mk(None, "batch", None, None),
                              state=mk(None, "batch", "ssm_heads", None, None)),
            k=kv5, v=kv5, pos=rep)
    if isinstance(cache, EncDecCache):
        # cross-attn KV: enc_len (1500) divides nothing; replicate seq dim
        cross = mk(None, "batch", "enc_seq", "kv_heads", None)
        return EncDecCache(k=kv5, v=kv5, ck=cross, cv=cross, pos=rep)
    raise TypeError(f"unknown cache type {type(cache)}")


def train_state_sharding(state, mesh, rules):
    """TrainState: the moments mirror the parameters' shardings; the step is
    replicated."""
    from repro_torch.training.optimizer import OptState
    from repro_torch.training.train_state import TrainState

    return TrainState(
        params=params_sharding(state.params, mesh, rules),
        opt=OptState(
            m=params_sharding(state.opt.m, mesh, rules),
            v=params_sharding(state.opt.v, mesh, rules),
            step=NamedSharding(mesh, P()),
        ),
        error_buf=(params_sharding(state.error_buf, mesh, rules)
                   if state.error_buf is not None else None),
    )
