"""The sharded train step, prefill and decode on a (2, 2) mesh of 4 gloo
ranks (``tests/_mesh_worker.py``, one process per rank) against the
mesh-less port, from the same seed and batch, float32 smoke configs: dense,
MoE, SSM and hybrid. Two steps' losses within rel 2e-3 (the reference's
claim, ``tests/test_model_consistency.py:68``), the parameters after them
within 1e-4, the prefill's and a decode step's logits within 1e-5. The
prefill launches ``flash_attention`` through its ``DTensor`` entry point
(``partitioning.attention_on_shards``); on the CPU that runs the kernel's
plain version on each rank's shards.

The MoE step runs twice: "pjit" is ``moe_mlp`` on ``DTensor``s at the
config's capacity; the default is ``moe_mlp_shardmap``, which differs from
the mesh-less block by design (per-rank capacity, per-shard aux loss), so
it runs at a capacity that drops no token and with the aux weight at 0
(``test_torch_mesh.py`` holds both against the reference's shardmap).
On a (1, 1) mesh of one rank (the card's phase 25 on the CPU) the
prefill's logits and cache, two steps' losses and every parameter are
bit-equal to the mesh-less port's, the MoE block going through
``moe_mlp_shardmap``.

Two runs serve every test (a module fixture, each with its own timeout):
the variants one after another on one 4-rank gloo group, and the unit
meshes in one process beside it.
"""
import pytest

from _mesh_worker import Ranks

ARCHS = ["qwen2.5-3b", "qwen2-moe-a2.7b", "qwen2-moe-a2.7b:pjit", "mamba2-130m", "zamba2-1.2b"]


UNIT = ["qwen2.5-3b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-1.2b"]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("steps")
    units = Ranks("units", 1, d, ",".join(UNIT), timeout=900)
    meshed = Ranks("steps", 4, d, ",".join(ARCHS), timeout=900).results()[0]
    return {**meshed, **{f"unit:{a}": r for a, r in units.results()[0].items()}}


@pytest.mark.parametrize("arch", UNIT)
def test_unit_mesh_is_bit_equal(arch, steps):
    r = steps[f"unit:{arch}"]
    assert r["logits"] and r.get("cache", True) and r["losses"] and r["params"], r


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_and_prefill_match_meshless(arch, steps):
    r = steps[arch]
    for plain, mesh in r["losses"]:
        assert abs(mesh - plain) <= 2e-3 * abs(plain)
    assert r["param_diff"] < 1e-4
    assert r["logits_diff"] <= 1e-5 * max(1.0, r["logits_scale"])
    assert r["decode_diff"] <= 1e-5 * max(1.0, r["logits_scale"])
    # the prefill's attention ran as flash_attention on each rank's shards:
    # 2 of the 4 lanes, and its share of the heads
    assert all(c[0] == "Tensor" and c[1] == 2 for c in r["flash_calls"])
    assert len(r["flash_calls"]) > 0 if r["flash"] else not r["flash_calls"]
