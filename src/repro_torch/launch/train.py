"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --smoke \\
        --steps 100 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --smoke

Wires together, as the reference's ``launch/train.py``: config ->
deterministic data pipeline with prefetch -> train step -> asynchronous
checkpointing -> heartbeat and straggler telemetry. It runs on the card;
``--device cpu`` runs it on the CPU. ``--smoke`` takes the reduced float32
config.

``--mesh test|prod`` trains on a device mesh (``launch/mesh.py``: 4 x 4 or
16 x 16, axes "data" and "model"), one process per device, as under
``torchrun``:

    torchrun --nproc-per-node 16 -m repro_torch.launch.train --smoke --mesh test

It needs a process group of the mesh's world size: one already initialised,
or torchrun's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; NCCL on the card, each rank on ``cuda:LOCAL_RANK``, gloo
with ``--device cpu``); without one it raises, naming the size. Every rank
builds the same state from the seed; ``launch.shardings.train_state_sharding``
distributes it (``rules_for(cfg, mesh)``, no shape, as the reference) and
the step runs under ``use_partitioning``. The batch is replicated, as the
reference's (its in_shardings leave it unconstrained); the model's
``shard`` annotations lay it out. Rank 0 prints and writes checkpoints (the
state gathered whole; a resume reads it on every rank and distributes it).

Every decoder-only architecture trains here (dense, MoE, VLM, the SSM and
the hybrid). The encoder-decoder (whisper-tiny) does not: its loss needs
the encoder's frame embeddings (``enc_embeds``), which the token pipeline
does not make (the reference's CLI fails on it inside the loss), so it is
refused up front; train it through ``get_model(cfg).loss`` with a batch
that holds ``enc_embeds``.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from contextlib import nullcontext

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.manager import resolve_device
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens
from repro_torch.launch import partitioning as part
from repro_torch.launch.mesh import build_mesh, mesh_shape
from repro_torch.launch.shardings import rules_for, train_state_sharding
from repro_torch.runtime.fault_tolerance import HeartbeatTracker, StragglerDetector
from repro_torch.training.optimizer import AdamWConfig, OptState, tree_map
from repro_torch.training.train_state import TrainState, init_train_state, make_train_step


def to_device(batch, device):
    """A host batch (numpy int32) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def init_mesh(kind: str, device: torch.device):
    """The ``kind`` mesh ("test" or "prod") over this process's group, and
    this rank's device: the group is the one initialised, else one made from
    torchrun's environment; without either it raises, naming the world size
    the mesh needs."""
    shape, names = mesh_shape(kind)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"--mesh {kind} needs a process group of world size {math.prod(shape)} "
                "(one rank per device, e.g. torchrun --nproc-per-node "
                f"{math.prod(shape)}); none is initialised and no WORLD_SIZE is set")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return build_mesh(shape, names, device_type=device.type), device


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def gather_state(state: TrainState) -> TrainState:
    """A distributed state as whole tensors on every rank (a collective)."""
    return TrainState(
        params=tree_map(_whole, state.params),
        opt=OptState(m=tree_map(_whole, state.opt.m), v=tree_map(_whole, state.opt.v),
                     step=_whole(state.opt.step)),
        error_buf=None if state.error_buf is None else tree_map(_whole, state.error_buf))


def _value(t) -> float:
    """A (replicated) scalar metric as a float."""
    return float(_whole(t))


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
    device = resolve_device(args.device, what="the trainer")
    mesh = None
    if args.mesh != "none":
        mesh, device = init_mesh(args.mesh, device)
    lead = mesh is None or dist.get_rank() == 0

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
        if lead:
            print(f"resumed from step {start_step}")
    pctx = nullcontext()
    if mesh is not None:
        rules = rules_for(cfg, mesh)
        state = part.distribute(state, train_state_sharding(state, mesh, rules))
        pctx = part.use_partitioning(mesh, rules)

    source = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=17))
    it = PrefetchIterator(source, start_step=start_step)
    hb = HeartbeatTracker([0], timeout=600.0)
    sd = StragglerDetector([0])

    t_start = time.time()
    try:
        with pctx:
            for i in range(start_step, args.steps):
                _, batch = next(it)
                t0 = time.time()
                state, metrics = step_fn(state, to_device(batch, device))
                loss = _value(metrics["loss"])  # waits for the step
                dt = time.time() - t0
                hb.beat(0)
                sd.record(0, dt)
                if lead and ((i + 1) % args.log_every == 0 or i == start_step):
                    toks = args.batch * args.seq / dt
                    print(f"step {i + 1:5d} loss={loss:.4f} "
                          f"gnorm={_value(metrics['grad_norm']):.3f} "
                          f"lr={_value(metrics['lr']):.2e} {dt * 1e3:6.1f} ms "
                          f"({toks:,.0f} tok/s)")
                if ckpt and (i + 1) % args.ckpt_every == 0:
                    whole = state if mesh is None else gather_state(state)
                    if lead:
                        ckpt.save(i + 1, whole, meta={"data_step": i + 1})
    finally:
        it.close()
        if ckpt:
            ckpt.wait()
    if lead:
        print(f"done: {args.steps - start_step} steps in {time.time() - t_start:.1f}s")
    return state


if __name__ == "__main__":
    main()
