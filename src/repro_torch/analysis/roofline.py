"""Roofline model on one NVIDIA H100 SXM (the port's target).

Three terms per (arch x shape x chips), all in seconds a step, from a
step's counted work (``analysis.hlo_cost``):

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / NVLINK_BW

The dominant term is the bottleneck; ``model_flops_per_step`` over the
counted FLOPs measures how much of the executed compute is useful (it
catches remat's second forward, masked blocks, MoE padding and replicated
compute). The model-FLOPs definition and its formulas are the reference's
(``src/repro/analysis/roofline.py``), evaluated in the same float64
arithmetic; only the hardware constants are the H100's.
"""
from __future__ import annotations

from dataclasses import dataclass

# --- one H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet, SXM column) -----
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (1,979e12 with sparsity)
HBM_BW = 3.35e12  # HBM3 bytes/s
NVLINK_BW = 450e9  # NVLink 4 bytes/s one way (900 GB/s both ways, 18 links)
HBM_BYTES = 80 << 30  # 80 GB of HBM3


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (counted FLOPs * chips)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs MFU bound at this step time: how close the useful
        work runs to the chips' peak given the dominant term."""
        if self.step_time_s <= 0:
            return 0.0
        chips_flops = self.flops_per_device / max(self.step_time_s, 1e-30)
        return min(chips_flops / PEAK_FLOPS, 1.0) * self.useful_ratio


def _attn_context_flops(cfg, shape, fwd_bwd: float) -> float:
    """Attention score + value matmul FLOPs (outside the N·D parameter rule).

    Full sequence: 4·B·h·dh per (query, key) pair, the pairs being S·ctx
    under a window and the causal half S²/2 otherwise; decode: 4·B·h·dh·ctx
    a step. ``fwd_bwd`` = 1 (inference) or 3 (train: forward + 2x backward;
    remat's recompute is not useful work)."""
    if not cfg.num_heads:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    L_attn = cfg.attn_invocations if cfg.family == "hybrid" else cfg.num_layers
    hd = cfg.num_heads * cfg.d_head
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
    if shape.kind == "decode":
        flops = 4.0 * B * L_attn * hd * ctx
        if cfg.is_encoder_decoder:
            flops += 4.0 * B * cfg.num_layers * hd * cfg.max_encoder_len
        return flops
    score_elems = S * ctx if cfg.sliding_window else S * S / 2
    flops = fwd_bwd * 4.0 * B * L_attn * hd * score_elems
    if cfg.is_encoder_decoder:
        T = cfg.max_encoder_len
        flops += fwd_bwd * 4.0 * B * cfg.encoder_layers * hd * T * T  # bidirectional encoder
        flops += fwd_bwd * 4.0 * B * cfg.num_layers * hd * S * T  # cross
    return flops


def model_flops_per_step(cfg, shape, n_chips: int) -> float:
    """Useful FLOPs: 6·N_active·D train / 2·N_active·D inference, plus the
    attention-context and SSD terms. Remat recompute, MoE capacity padding,
    masked blocks and replicated compute are left out on purpose; their
    absence is what ``useful_ratio`` measures."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        # the encoder processes enc_len frames, the decoder S tokens
        d = cfg.d_model
        enc_p = cfg.encoder_layers * (cfg._attn_params() + cfg._mlp_params() + 2 * d)
        dec_p = cfg.num_layers * (2 * cfg._attn_params() + cfg._mlp_params() + 3 * d)
        head_p = cfg.vocab_size * d
        mult = 6.0 if shape.kind == "train" else 2.0
        if shape.kind == "decode":
            flops = mult * (dec_p + head_p) * B  # the encoder already ran
        else:
            flops = mult * (enc_p * B * cfg.max_encoder_len + (dec_p + head_p) * B * S)
        return flops + _attn_context_flops(cfg, shape, 3.0 if shape.kind == "train" else 1.0)
    if shape.kind == "train":
        return (6.0 * n_active * B * S + _attn_context_flops(cfg, shape, 3.0)
                + _ssd_context_flops(cfg, shape, 3.0))
    if shape.kind == "prefill":
        return (2.0 * n_active * B * S + _attn_context_flops(cfg, shape, 1.0)
                + _ssd_context_flops(cfg, shape, 1.0))
    return 2.0 * n_active * B + _attn_context_flops(cfg, shape, 1.0)


def _ssd_context_flops(cfg, shape, fwd_bwd: float) -> float:
    """SSD (Mamba2) within-chunk and state matmuls, not covered by N·D:
    per token and layer 2·(Q·N + d_inner·Q + 2·d_inner·N)."""
    if not cfg.ssm_state:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    Q, N, di = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_d_inner
    per_tok = 2.0 * (Q * N + di * Q + 2 * di * N)
    return fwd_bwd * B * S * cfg.num_layers * per_tok


def compute_terms(
    cfg,
    shape,
    n_chips: int,
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_dev: float,
) -> RooflineTerms:
    mf = model_flops_per_step(cfg, shape, n_chips)
    total = flops_per_device * n_chips
    return RooflineTerms(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=collective_bytes_dev / NVLINK_BW,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes=collective_bytes_dev,
        model_flops=mf,
        useful_ratio=min(mf / max(total, 1.0), 1.0),
    )
