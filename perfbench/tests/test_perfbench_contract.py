"""The benchmark's own checks on the CPU: BENCHMARK.json's form, the files it
names, the traffic's dependence on the seed, the frozen cost functions
against the port's, and what the harness and the references import."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from perfbench import costs, harness, traffic

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    for p in b["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(ROOT, "perfbench", "systems", cfg["system"] + ".py"))
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "perfbench", "workloads", w["name"] + ".json"))
    for text in [c["why"] for c in b["configs"]] + [w["why"] for w in b["workloads"]] + \
            [c["source"] for c in b["configs"]] + [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        cell = harness.load_cell(w)
        assert any(m["name"] != "setup_s" for m in cell["end_to_end"])
        assert cell["per_layer"]


def test_every_reader_loads():
    names = [f[:-3] for f in os.listdir(os.path.join(ROOT, "perfbench", "metrics"))
             if f.endswith(".py")]
    assert {m["name"] for m in bench()["per_layer"]} <= set(names)
    for n in names:
        assert NAME.match(n) and callable(harness.reader(n))


def small_kvs():
    cfg = harness.load_cell("kvs-gups-8m.colocate")["config"]
    P = 4096
    kv = round(P * 320 / 576)
    cfg.update(pages=P, fast_capacity=P // 4)
    cfg["tenants"][0]["pages"], cfg["tenants"][1]["pages"] = kv, P - kv
    owners = [torch.arange(0, kv), torch.arange(kv, P)]
    return cfg, owners


def test_kvs_traffic_follows_the_seed():
    cfg, owners = small_kvs()

    def draw(seed):
        rates = traffic.page_rates(cfg, owners, seed, "cpu")
        return rates, traffic.epoch_cycle(rates, 3, seed)

    r1, c1 = draw(2**31 + 7)
    r2, c2 = draw(2**31 + 7)
    r3, c3 = draw(2**31 + 8)
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    assert not torch.equal(r1, r3) and not torch.equal(c1, c3)
    # another seed moves the hot set, not how much traffic there is
    assert abs(float(r1.sum()) - float(r3.sum())) <= 1e-4 * float(r1.sum())
    kvs = cfg["tenants"][0]
    hot = int(kvs["hot"]["pages"] * kvs["pages"])
    top = torch.sort(r1[: kvs["pages"]], descending=True).values
    assert float(top[:hot].sum()) == pytest.approx(0.9 * float(top.sum()), rel=1e-4)


def test_the_cell_is_one_share_of_the_source_machine():
    """Pages, the fast tier and the migration rate are the source machine's
    (Table 1's 576 GiB in 4 KiB pages, 128 GiB of DRAM, 4 GiB/s) cut by one
    share, and each tenant keeps its share of the pages."""
    cfg = harness.load_cell("kvs-gups-8m.colocate")["config"]
    src = cfg["source_machine"]
    assert src["pages"] == 576 * 2**30 // 4096
    P = cfg["pages"]
    assert cfg["fast_capacity"] == src["fast_pages"] * P // src["pages"]
    rate = int(src["migration_pages_per_s"] * cfg["machine"]["epoch_s"]) * P // src["pages"]
    assert cfg["migration_budget"] == cfg["migration_bandwidth"] == rate
    kvs, gups = cfg["tenants"]
    assert kvs["pages"] + gups["pages"] == P and kvs["pages"] == round(P * 320 / 576)


def test_a_page_is_accessed_at_the_source_machines_rate():
    """Cutting the machine cuts the accesses with it: the mean rate of a
    page is the same at any number of pages."""
    cfg, owners = small_kvs()
    big = json.loads(json.dumps(cfg))
    P = 4 * cfg["pages"]
    kv = round(P * 320 / 576)
    big.update(pages=P, fast_capacity=4 * cfg["fast_capacity"])
    big["tenants"][0]["pages"], big["tenants"][1]["pages"] = kv, P - kv
    r_small = traffic.page_rates(cfg, owners, 3, "cpu")
    r_big = traffic.page_rates(big, [torch.arange(0, kv), torch.arange(kv, P)], 3, "cpu")
    assert float(r_small.mean()) == pytest.approx(float(r_big.mean()), rel=1e-3)
    share = cfg["pages"] / cfg["source_machine"]["pages"]
    slow = 1 - cfg["fast_capacity"] / cfg["pages"]
    ops = sum(traffic.ops_per_epoch(t, cfg["machine"], slow) for t in cfg["tenants"])
    assert float(r_small.sum()) == pytest.approx(ops * share, rel=1e-4)


def test_ops_per_epoch_is_the_simulators_arithmetic():
    cfg, _ = small_kvs()
    mach = cfg["machine"]
    kvs, gups = cfg["tenants"]
    # 4 / (0.25 (80 + 16384 / 100) + 0.75 (300 + 16384 / 30)) ns
    assert traffic.ops_per_epoch(kvs, mach, 0.75) == pytest.approx(
        4 / (0.25 * 243.84 + 0.75 * (300 + 16384 / 30)) * 1e9)
    assert traffic.ops_per_epoch(gups, mach, 0.75) == pytest.approx(
        8 / (0.25 * 80.64 + 0.75 * (300 + 64 / 30)) * 1e9)


def test_frozen_costs_equal_the_ports():
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(5)
    pool = torch.zeros(300, 32)
    src = torch.randint(-2, 310, (64,), generator=g, dtype=torch.int32)
    dst = torch.randint(-2, 310, (64,), generator=g, dtype=torch.int32)
    dst[:5] = src[:5]
    assert (0.0, float(costs.page_move_bytes(pool, src, dst))) == ops.page_move_cost(pool, src, dst)


def test_peaks_equal_the_ports_table():
    from perfbench import peaks
    from repro_torch.analysis import roofline

    assert peaks.HBM_BYTES_PER_S == roofline.HBM_BW


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "src")])))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_loads_no_jax_and_reference_no_program():
    mods = _modules_after(
        "from perfbench import harness, trace, traffic, costs, peaks\n"
        "from perfbench.systems import manager\n"
        "import repro_torch.core.manager, repro_torch.kernels.ops\n"
        "import glob, os\n"
        "for p in glob.glob('perfbench/metrics/*.py'):\n"
        "    harness.reader(os.path.basename(p)[:-3])\n")
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
    mods = _modules_after("import perfbench.reference.maxmem, perfbench.reference.pages")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "kvs-gups-8m.colocate",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_trace_reduction_attributes_by_launch():
    """A device operation belongs to the innermost harness range open when
    its launch call ran; idle gaps are named by the host range open then."""
    from perfbench.trace import Trace, _innermost

    ranges = {"window": [(0, 1000)], "run_epoch": [(0, 900)], "page_move": [(500, 600)]}
    assert _innermost(ranges, 550) == "page_move"
    assert _innermost(ranges, 100) == "run_epoch"
    ops = [(100, 200, "tick_kernel", "run_epoch"), (650, 700, "move_pass_a", "page_move"),
           (680, 750, "move_pass_b", "page_move")]
    t = Trace(ops, {k: v for k, v in ranges.items()}, (0, 1000), 1e-6)
    assert t.busy_s == pytest.approx(200e-9)
    assert t.device_s("page_move") == pytest.approx(120e-9)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "tick_kernel"
    gaps = dict(bd["idle_gaps"])
    assert gaps == pytest.approx({"run_epoch": 800e-9})
