"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \\
        --steps 100 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --smoke

Wires together, as the reference's ``launch/train.py``: config ->
deterministic data pipeline with prefetch -> train step -> asynchronous
checkpointing -> heartbeat and straggler telemetry. It runs on the card;
``--device cpu`` runs it on the CPU. ``--smoke`` takes the reduced float32
config. ``--mesh test|prod`` needs a device mesh, which waits for ROADMAP
Queue 1 item 11.

Every decoder-only architecture trains here (dense, MoE, VLM, the SSM and
the hybrid). The encoder-decoder (whisper-tiny) does not: its loss needs
the encoder's frame embeddings (``enc_embeds``), which the token pipeline
does not make (the reference's CLI fails on it inside the loss), so it is
refused up front; train it through ``get_model(cfg).loss`` with a batch
that holds ``enc_embeds``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.manager import resolve_device
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens
from repro_torch.runtime.fault_tolerance import HeartbeatTracker, StragglerDetector
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_state import init_train_state, make_train_step


def to_device(batch, device):
    """A host batch (numpy int32) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced float32 config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["none", "test", "prod"], default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh} needs a device mesh: it waits for ROADMAP Queue 1 item 11")
    device = resolve_device(args.device, what="the trainer")

    cfg = get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{args.arch} is an encoder-decoder: its loss needs enc_embeds (the encoder's frame "
            "embeddings), which the token pipeline does not make; train it through "
            "get_model(cfg).loss with a batch holding enc_embeds")
    if args.smoke:
        cfg = cfg.smoke()
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    state = init_train_state(cfg, 0, device=device)
    step_fn = make_train_step(cfg, opt_cfg)

    start_step = 0
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(state)
        start_step = int(meta.get("data_step", ckpt.latest_step()))
        print(f"resumed from step {start_step}")

    source = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=17))
    it = PrefetchIterator(source, start_step=start_step)
    hb = HeartbeatTracker([0], timeout=600.0)
    sd = StragglerDetector([0])

    t_start = time.time()
    try:
        for i in range(start_step, args.steps):
            _, batch = next(it)
            t0 = time.time()
            state, metrics = step_fn(state, to_device(batch, device))
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            hb.beat(0)
            sd.record(0, dt)
            if (i + 1) % args.log_every == 0 or i == start_step:
                toks = args.batch * args.seq / dt
                print(f"step {i + 1:5d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {dt * 1e3:6.1f} ms "
                      f"({toks:,.0f} tok/s)")
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save(i + 1, state, meta={"data_step": i + 1})
    finally:
        it.close()
        if ckpt:
            ckpt.wait()
    print(f"done: {args.steps - start_step} steps in {time.time() - t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
