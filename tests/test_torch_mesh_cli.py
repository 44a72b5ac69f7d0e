"""``launch/train.py --mesh test`` on 16 gloo ranks, as under torchrun.

Each rank is a process of ``python -m repro_torch.launch.train --smoke
--mesh test --device cpu`` with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR=localhost``, ``MASTER_PORT``);
the trainer makes the gloo group and the 4 x 4 mesh itself. Two steps; each
loss rank 0 prints is within rel 2e-3 (the reference's claim) of the same
steps with ``--mesh none``; rank 0's checkpoint of the gathered state
restores into a plain state, its parameters within 1e-3 of the mesh-less
run's.
"""
import os
import re
import socket
import subprocess
import sys

from _mesh_worker import below_the_workers
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.training.optimizer import named_leaves
from repro_torch.training.train_state import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--smoke", "--steps", "2", "--log-every", "1", "--device", "cpu"]


def _losses(text):
    return [float(v) for v in re.findall(r"loss=([0-9.]+)", text)]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_mesh_test_trains_on_16_gloo_ranks(capsys, tmp_path):
    world, port = 16, _free_port()
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
                   RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--mesh", "test", *ckpt],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=below_the_workers))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    meshed = _losses(logs[0])
    assert all(not _losses(log) for log in logs[1:])  # only rank 0 prints

    state = train.main(ARGS)
    plain = _losses(capsys.readouterr().out)
    assert len(meshed) == len(plain) == 2
    for a, b in zip(meshed, plain):
        assert abs(a - b) <= 2e-3 * abs(b)
    saved = Checkpointer(str(tmp_path / "ckpt"))
    assert saved.latest_step() == 2
    restored, meta = saved.restore(init_train_state(get_config("qwen2.5-3b").smoke(), 0,
                                                    device="cpu"))
    assert meta["data_step"] == 2 and int(restored.opt.step) == 2
    for (_, a), (_, b) in zip(named_leaves(restored.params), named_leaves(state.params)):
        assert float((a - b).abs().max()) <= 1e-3
