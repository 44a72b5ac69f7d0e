"""The port's data pipeline, checkpointer, trainer fault tolerance and
training CLI on the CPU: batches bit-equal with the JAX package's, and the
reference's data, checkpoint and fault-tolerance tests run on the port
(round trip, bf16 leaves bit for bit, restart equivalence, atomicity and
pruning, heartbeats, stragglers, the elastic mesh plan and runner), then
``launch.train.main`` straight against stopped and resumed.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens
from repro_torch.launch import train
from repro_torch.runtime.fault_tolerance import (
    ElasticRunner,
    HeartbeatTracker,
    StragglerDetector,
    plan_elastic_mesh,
)
from repro_torch.training.optimizer import AdamWConfig, named_leaves
from repro_torch.training.train_state import init_train_state, make_train_step


@pytest.fixture(scope="module")
def smoke_cfg():
    return get_config("qwen2.5-3b").smoke()


@pytest.fixture
def deterministic():
    """Bit-equal reruns need deterministic kernels: the embedding's backward
    (an accumulating ``index_put_``) adds in thread order otherwise, on the
    CPU as on the card."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _state_leaves(state):
    out = [t for _, t in named_leaves(state.params)]
    out += [t for _, t in named_leaves(state.opt.m)] + [t for _, t in named_leaves(state.opt.v)]
    return out + [state.opt.step]


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (100, 32, 8, 7, 4), (256, 16, 4, 3, 1), (151936, 64, 2, 17, 2), (50, 8, 2, 2, 1)])
def test_batches_bit_equal_with_reference(vocab, seq, batch, seed, shards):
    for shard in range(shards):
        ours = SyntheticTokens(DataConfig(vocab, seq, batch, seed=seed), shard, shards)
        ref = JaxTokens(JaxDataConfig(vocab, seq, batch, seed=seed), shard, shards)
        for step in (0, 1, 5):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                assert np.array_equal(a[k], b[k]), (shard, step, k)


class TestData:
    def test_determinism_across_shardings(self):
        cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=8, seed=7)
        whole = SyntheticTokens(cfg, shard=0, num_shards=1).batch_at(3)
        parts = [SyntheticTokens(cfg, shard=s, num_shards=4).batch_at(3) for s in range(4)]
        merged = np.concatenate([p["tokens"] for p in parts], axis=0)
        assert (merged == whole["tokens"]).all()

    def test_labels_are_shifted_tokens(self):
        b = SyntheticTokens(DataConfig(vocab_size=100, seq_len=16, global_batch=2, seed=1)
                            ).batch_at(0)
        assert b["tokens"].shape == (2, 16)
        assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()

    def test_prefetch_matches_direct(self):
        src = SyntheticTokens(DataConfig(vocab_size=50, seq_len=8, global_batch=2, seed=2))
        it = PrefetchIterator(src, start_step=0, depth=2)
        try:
            for want_step in range(5):
                step, batch = next(it)
                assert step == want_step
                ref = src.batch_at(step)
                for k in ("tokens", "labels"):
                    assert (batch[k] == ref[k]).all()
        finally:
            it.close()
        assert not it._thread.is_alive()


# ------------------------------------------------------------ checkpoint
class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, compress_grads=True, device="cpu")
        ck = Checkpointer(str(tmp_path), keep=2)
        ck.save(0, state, meta={"data_step": 0}, blocking=True)
        restored, meta = ck.restore(state)
        assert type(restored) is type(state) and restored.error_buf is not None
        for a, b in zip(_state_leaves(state), _state_leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert meta["data_step"] == 0
        with open(tmp_path / "step_00000000" / "MANIFEST.json") as f:
            manifest = json.load(f)
        assert manifest["step"] == 0 and "params.embed" in manifest["leaves"]
        assert manifest["leaves"]["opt.step"]["dtype"] == "int32"

    def test_bf16_leaves_restore_bit_for_bit(self, tmp_path, smoke_cfg):
        cfg = dataclasses.replace(smoke_cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
        state = init_train_state(cfg, 0, device="cpu")
        emb = state.params["embed"]
        emb.view(torch.int16)[0, :4] = torch.tensor([0x7F80, -0x80, 0x0001, 0x7FC1],
                                                   dtype=torch.int16)  # inf, -inf, denormal, nan
        ck = Checkpointer(str(tmp_path))
        ck.save(7, state, blocking=True)
        with open(tmp_path / "step_00000007" / "MANIFEST.json") as f:
            ent = json.load(f)["leaves"]["params.embed"]
        assert ent["dtype"] == "bfloat16"
        assert np.load(tmp_path / "step_00000007" / ent["file"]).dtype == np.uint16
        restored, _ = ck.restore(state)
        for a, b in zip(_state_leaves(state), _state_leaves(restored)):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)

    def test_restart_equivalence(self, tmp_path, smoke_cfg, deterministic):
        """Train 6 steps straight == train 3, checkpoint, restore, train 3."""
        step = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3, warmup_steps=2))
        data = SyntheticTokens(DataConfig(smoke_cfg.vocab_size, 16, 2, seed=3))

        def run(state, start, n):
            for s in range(start, start + n):
                state, _ = step(state, _to_torch(data.batch_at(s)))
            return state

        s_direct = run(init_train_state(smoke_cfg, 0, device="cpu"), 0, 6)
        s_a = run(init_train_state(smoke_cfg, 0, device="cpu"), 0, 3)
        ck = Checkpointer(str(tmp_path))
        ck.save(3, s_a, blocking=True)
        s_b, _ = ck.restore(init_train_state(smoke_cfg, 1, device="cpu"))
        s_b = run(s_b, 3, 3)
        for a, b in zip(_state_leaves(s_direct), _state_leaves(s_b)):
            assert torch.equal(a, b)

    def test_atomicity_prunes_and_latest(self, tmp_path, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, device="cpu")
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in [0, 10, 20]:
            ck.save(s, state, blocking=True)
        assert ck.all_steps() == [10, 20]
        assert ck.latest_step() == 20
        assert not any(d.startswith("tmp.") for d in os.listdir(tmp_path))

    def test_background_write_and_missing_leaf(self, tmp_path, smoke_cfg):
        state = init_train_state(smoke_cfg, 0, device="cpu")
        ck = Checkpointer(str(tmp_path))
        before = state.params["embed"].clone()
        ck.save(1, state)  # written on the background thread
        state.params["embed"].add_(1.0)  # the next train step writes in place
        ck.wait()
        assert ck.latest_step() == 1
        assert torch.equal(ck.restore(state)[0].params["embed"], before)
        with pytest.raises(KeyError, match="missing leaf"):
            ck.restore(init_train_state(smoke_cfg, 0, compress_grads=True, device="cpu"))
        with pytest.raises(FileNotFoundError):
            Checkpointer(str(tmp_path / "empty")).restore(state)


# ------------------------------------------------------------ fault tolerance
class TestFaultTolerance:
    def test_heartbeat_detects_death(self):
        t = [0.0]
        hb = HeartbeatTracker([0, 1, 2], timeout=5.0, clock=lambda: t[0])
        t[0] = 3.0
        hb.beat(0)
        hb.beat(1)
        t[0] = 7.0
        assert hb.check() == [2]
        assert hb.alive_hosts() == [0, 1]

    def test_straggler_detection(self):
        sd = StragglerDetector([0, 1, 2, 3], ratio=1.5)
        for _ in range(5):
            for h in range(3):
                sd.record(h, 1.0)
            sd.record(3, 3.0)
        assert sd.stragglers() == [3]

    def test_elastic_mesh_plan(self):
        assert plan_elastic_mesh(32, 8, 16) == (16, 16)
        assert plan_elastic_mesh(31, 8, 16) == (8, 16)
        with pytest.raises(RuntimeError):
            plan_elastic_mesh(1, 8, 16)

    def test_elastic_runner_restores_and_continues(self, tmp_path, smoke_cfg):
        data = SyntheticTokens(DataConfig(smoke_cfg.vocab_size, 16, 2, seed=5))
        tstep = make_train_step(smoke_cfg, AdamWConfig(lr=1e-3))

        def make_step(world_size):
            def fn(state, step):
                return tstep(state, _to_torch(data.batch_at(step)))[0]
            return fn

        runner = ElasticRunner(Checkpointer(str(tmp_path)), make_step, save_every=4)
        final, world = runner.run(init_train_state(smoke_cfg, 0, device="cpu"), world_size=8,
                                  n_steps=12, fail_at=[6])
        assert runner.restarts == 1
        assert world == 4
        assert int(final.opt.step) >= 12 - 4


# ------------------------------------------------------------ the CLI
def test_train_main_resumed_equals_straight(tmp_path, capsys, deterministic):
    """12 steps straight; then a checkpoint directory holding only step 6
    resumed to step 12: the final state is the same bit for bit, and so is
    the step-12 checkpoint each run wrote."""
    args = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--steps", "12",
            "--ckpt-every", "6", "--log-every", "6"]
    straight = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000006", "step_00000012"]
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000006", tmp_path / "b" / "step_00000006")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done: 6 steps" in out
    for a, b in zip(_state_leaves(straight), _state_leaves(resumed)):
        assert torch.equal(a, b)
    assert int(resumed.opt.step) == 12
    for d in ("a", "b"):
        ck = Checkpointer(str(tmp_path / d))
        assert ck.latest_step() == 12
    ra, _ = Checkpointer(str(tmp_path / "a")).restore(straight)
    rb, _ = Checkpointer(str(tmp_path / "b")).restore(straight)
    for a, b in zip(_state_leaves(ra), _state_leaves(rb)):
        assert torch.equal(a, b)


def test_trainer_defaults_to_the_card(monkeypatch):
    """The trainer and its state run on the card unless asked for the CPU;
    without a GPU the default raises. ``--mesh test`` without a process group
    of the mesh's world size raises, naming the size."""
    from repro_torch.training.train_state import init_train_state as init

    cfg = get_config("qwen2.5-3b").smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(cfg, 0)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="process group of world size 16"):
        train.main(["--smoke", "--steps", "1", "--mesh", "test", "--device", "cpu"])
    state = train.main(["--smoke", "--steps", "1", "--seq", "16", "--batch", "2",
                        "--device", "cpu"])
    assert state.params["embed"].device.type == "cpu" and int(state.opt.step) == 1
