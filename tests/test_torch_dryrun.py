"""The port's dry-run (``python -m repro_torch.launch.dryrun --test-mesh``)
on the four cells of ``tests/test_dryrun_small.py``, with that file's
assertions: each cell is counted as rank 0 of a fake process group of 16
ranks on fake CPU tensors, in its own subprocess (every cell starts at
once), and writes ``flops_per_device > 0``, a dominant roofline term and
integer ``temp_bytes`` / ``peak_bytes`` from the same counted run.

Also: the counter counts rank 0's local program; and the sharding divides
the work. The test-mesh ``qwen2.5-3b train_4k``
cell cut to 2 layers counts, times 16 devices, within 1.0-1.5x of the same
step unsharded at the same global batch (a replicated operation would
count near 16x).
"""
import json
import os
import subprocess
import sys

import pytest

from _mesh_worker import Ranks, below_the_workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [
    ("qwen2.5-3b", "train_4k", ()),  # dense train
    ("qwen2-moe-a2.7b", "decode_32k", ()),  # MoE decode (padded experts)
    ("mamba2-130m", "long_500k", ()),  # SSM long-context decode (B=1)
    ("yi-6b", "train_4k", ("--multi-pod",)),  # the multi-pod cell
]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = {(a, s): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s,
         "--test-mesh", "--device", "cpu", "--out-dir", str(d), *extra],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=below_the_workers)
        for a, s, extra in CELLS}
    counts = Ranks("counts", 1, d, "qwen2.5-3b:train_4k", timeout=600)
    out = {}
    try:
        for key, p in procs.items():
            out[key] = (p.returncode if p.wait(timeout=600) is not None else None,
                        p.communicate()[0])
    finally:
        for p in procs.values():
            p.kill()
    counts = counts.results()[0]
    return d, out, counts["ratio"], counts["local"]


@pytest.mark.parametrize("arch,shape,extra", CELLS, ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_cell_counts_on_test_mesh(arch, shape, extra, cells):
    d, out, *_ = cells
    rc, log = out[(arch, shape)]
    assert rc == 0, log[-3000:]
    assert "1/1 cells counted" in log
    sub = "multipod" if extra else "testmesh"
    data = json.loads((d / sub / f"{arch}__{shape}.json").read_text())
    assert data["n_chips"] == 16 and data["mesh"] == ([2, 2, 4] if extra else [4, 4])
    assert data["flops_per_device"] > 0
    assert data["roofline"]["dominant"] in ("compute", "memory", "collective")
    mem = data["memory"]
    assert mem["argument_bytes"] > 0
    assert isinstance(mem["peak_bytes"], int) and isinstance(mem["temp_bytes"], int)
    assert mem["peak_bytes"] >= max(mem["argument_bytes"], mem["output_bytes"])
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert data["xla_cost_analysis"] == {"flops": None, "bytes": None}


def test_count_is_the_local_program(cells):
    """The counter sees the local product (2 x 32 x 64 x 128 FLOPs) and the
    all-reduce's 32 x 128 float32 result, on real and fake tensors, the
    first call as the second: ``DTensor``'s sharding propagation runs the
    global [64, 128] x [128, 128] product on fake tensors once, uncounted."""
    for flops, coll in cells[3]:
        assert flops == 2 * 32 * 64 * 128 and coll == {"all-reduce": 32 * 128 * 4}


def test_sharding_divides_the_work(cells):
    r = cells[2]
    ratio = r["per_device"] * r["n"] / r["whole"]
    assert 1.0 <= ratio <= 1.5, ratio
    assert r["collectives"]["all-gather"] > 0 and r["collectives"]["reduce-scatter"] > 0
