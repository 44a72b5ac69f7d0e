"""The port's mesh layer and sharded paths on several CPU processes.

Every check that makes a process group runs in subprocesses
(``tests/_mesh_worker.py``, one process per rank, gloo over a FileStore or a
fake group; a process group is process-global), each with its own timeout.
The reference runs in its own subprocess where it needs several host
devices (``XLA_FLAGS``), on a mesh with Auto axes (jax 0.9's ``make_mesh``
gives Explicit axes, on which the reference's ``with_sharding_constraint``
raises; ROADMAP Queue 3 item 8).

  * meshes: (4, 4) and (2, 2, 4) over a 16-rank fake group, names and
    sizes; the errors without a group of the right size;
  * ``to_placements``: the block each rank of a (2, 2) mesh holds equals the
    block JAX's ``NamedSharding`` gives the device at the same position
    (nested sharding major to minor);
  * ``shardmap_int8_psum``: one rank and two ranks of equal shards bit-equal
    to the reference; differing scales within s/2 of the float mean, where
    the reference's formula (recorded here) is not;
  * ``moe_mlp_shardmap`` against the reference's on a unit mesh and a
    (1, 2) mesh, two MoE configs: gate ids equal, outputs within 1e-5, aux
    equal;
  * ``flash_attention`` and ``paged_attention`` on ``DTensor``s of a (2, 2)
    gloo mesh (lanes and heads split alike; q heads inside one kv group a
    rank; whole groups a rank; a split sequence, gathered first) equal to
    the entry points on the whole tensors, wrapped back as ``DTensor``s.

Four runs serve every test (a module fixture): the meshes (one process),
a (2, 2) gloo mesh (placements, attention; 4), the reference (one process
on 4 host devices: placements, int8, the shardmap MoE's weights and
results), then a gloo group of 1 and of 2 (int8 and the shardmap MoE).
"""
import numpy as np
import pytest

from _mesh_worker import ATTN_LAYOUTS, MOE_ARCHS, Ranks


# ---------------------------------------------------------------- the runs
INT8 = {  # name: (ranks, input)
    "one_rank": (1, np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)),
    "equal_shards": (2, np.tile(np.random.default_rng(1).normal(size=(3, 5)), (2, 1))),
    "differing_scales": (2, np.array([1.0, 0.5, 100.0, -50.0])),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's results; the reference writes the MoE weights the small
    groups read, so they start after it."""
    d = tmp_path_factory.mktemp("mesh")
    names = {}
    for world in (1, 2):
        names[world] = [n for n, (w, _) in INT8.items() if w == world]
        np.savez(d / f"x{world}.npz", **{f"x{i}": INT8[n][1].astype(np.float32)
                                         for i, n in enumerate(names[world])})
    mesh = Ranks("mesh", 1, d)
    shards = Ranks("shards", 4, d)
    ref = Ranks("ref", 4, d, str(d), ref=True).results()[0]
    small = {w: Ranks("small", w, d, str(d), tag=str(w)) for w in (1, 2)}
    out = {"mesh": mesh.results()[0], "shards": shards.results(), "ref": ref,
           "dir": d, "int8": {}, "moe": {}}
    for w, r in small.items():
        res = r.results()[0]
        out["moe"][w] = res["moe"]
        for i, n in enumerate(names[w]):
            out["int8"][n] = (np.asarray(res["int8"][i], np.float32),
                              np.asarray(ref["int8"][str(w)][i], np.float32))
    return out


# ---------------------------------------------------------------- meshes
def test_test_meshes_over_a_fake_group(runs):
    r = runs["mesh"]
    assert r["False"] == {"names": ["data", "model"], "sizes": [4, 4],
                          "axis_sizes": {"data": 4, "model": 4}, "coordinate": [0, 0]}
    assert r["True"] == {"names": ["pod", "data", "model"], "sizes": [2, 2, 4],
                         "axis_sizes": {"pod": 2, "data": 2, "model": 4},
                         "coordinate": [0, 0, 0]}
    assert "world size 256; this one has 16" in r["prod_error"]


def test_meshes_need_a_group_of_their_size(runs):
    r = runs["mesh"]
    assert "a 4x4 mesh needs a process group of world size 16" in r["no_group test_False"]
    assert "none is initialised" in r["no_group test_False"]
    assert "a 2x16x16 mesh needs a process group of world size 512" in r["no_group prod_True"]


def test_to_placements_matches_jax_blocks(runs):
    ref = runs["ref"]["placements"]
    for r in runs["shards"]:
        c = r["coordinate"]
        for i, block in enumerate(r["blocks"]):
            assert block == ref[f"{i}:{c[0]},{c[1]}"], (i, c)


# ------------------------------------------------------------------ int8
def test_int8_psum_one_rank_is_the_reference(runs):
    ours, ref = runs["int8"]["one_rank"]
    assert np.array_equal(ours, ref)


def test_int8_psum_equal_shards_is_the_reference(runs):
    ours, ref = runs["int8"]["equal_shards"]
    assert np.array_equal(ours, ref)


def test_int8_psum_differing_scales_within_half_a_step(runs):
    """Shards [1, 0.5] and [100, -50]: the mean is [50.5, -24.75]. The
    reference dequantises codes of different scales with the largest and
    gives [100, 0]; the port, with the scale shared before quantising, is
    within s/2 of the mean (s = 100 / 127)."""
    ours, ref = runs["int8"]["differing_scales"]
    mean = np.array([50.5, -24.75], np.float32)
    s = 100.0 / 127.0
    assert np.array_equal(ref, [100.0, 0.0, 100.0, 0.0])
    assert np.abs(ref[:2] - mean).max() > 20 * s
    assert np.abs(ours[:2] - mean).max() <= s / 2
    assert np.array_equal(ours[:2], ours[2:])


# ------------------------------------------------------------------- MoE
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_shardmap_matches_reference(arch, world, runs):
    ours = runs["moe"][world][arch]
    z = np.load(runs["dir"] / f"moe{world}" / f"{arch}.npz")
    assert np.array_equal(np.asarray(ours["gate_ids"]), z["gate_ids"])
    np.testing.assert_allclose(np.asarray(ours["out"]), z["out"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(ours["plain_out"]), z["out"], atol=1e-5, rtol=0)
    assert ours["aux"] == ours["plain_aux"]
    assert abs(ours["aux"] - float(z["aux"])) <= 1e-7 * abs(float(z["aux"]))


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("layout", list(ATTN_LAYOUTS))
@pytest.mark.parametrize("kernel", ["flash", "paged"])
def test_attention_entry_points_on_shards(kernel, layout, runs):
    for r in runs["shards"]:  # every rank holds the whole result
        is_dtensor, diff, placements = r["attention"][f"{kernel} {layout}"]
        assert is_dtensor and diff == 0.0
        want = {"lanes_heads": ["S(0)", "S(1)"], "heads_in_one_group": ["R", "S(1)"],
                "groups_per_rank": ["S(0)", "S(1)"], "sequence": ["R", "R"]}[layout]
        assert placements == want
