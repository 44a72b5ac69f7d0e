"""The port stands alone: it imports neither JAX nor the JAX package nor the
reference's ``benchmarks`` (which imports the JAX package), nor ``msgpack``
or ``ml_dtypes`` (the reference's checkpoint format needs them), runs on the
card unless asked for the CPU, and has no silent fallback. This file
imports no JAX either, so its ``cuda`` test runs on a machine with only
PyTorch."""
import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    roots = set(_imported_roots(path))
    # msgpack and ml_dtypes are not on the machine with the card
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks", "msgpack", "ml_dtypes"}, roots


def test_manager_defaults_to_the_card(monkeypatch):
    from repro_torch.core.manager import CentralManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CentralManager(num_pages=16, fast_capacity=4, migration_budget=4)
    m = CentralManager(num_pages=16, fast_capacity=4, migration_budget=4, device="cpu")
    assert m.device.type == "cpu"


def test_serving_defaults_to_the_card(monkeypatch):
    """The model, the KV pools and the engine run on the card unless asked
    for the CPU; without a GPU the default raises."""
    from repro_torch.configs import get_config
    from repro_torch.core.manager import CentralManager
    from repro_torch.kvcache.paged import TieredPagedKV
    from repro_torch.models.model import get_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("yi-6b").smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TieredPagedKV(cfg, 4, 12, page_tokens=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg).init(seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, None, CentralManager(num_pages=16, fast_capacity=4,
                                                migration_budget=4),
                      TieredPagedKV(cfg, 4, 12, page_tokens=4, device="cpu"))
    m = CentralManager(num_pages=16, fast_capacity=4, migration_budget=4, device="cpu")
    eng = ServingEngine(cfg, get_model(cfg).init(seed=0, device="cpu"), m,
                        TieredPagedKV(cfg, 4, 12, page_tokens=4, device="cpu"))
    assert eng.device.type == "cpu"


def test_autotuner_defaults_to_the_card(monkeypatch):
    """The offline search, the online tuner (whose burst builds its clones on
    the tuner's device) and the CLI run on the card unless asked for the
    CPU; without a GPU the default raises."""
    from repro_torch.core.manager import CentralManager
    from repro_torch.core.simulator import OPTANE, ColocationSim
    from repro_torch.launch import hillclimb

    geom = hillclimb.TunerGeometry(n_pages=256, n_epochs=4, fast=32, policy_chunk=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.PolicyAutotuner("skewshift", geom, population=2, generations=1, elites=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.main(["--scenario", "skewshift", "--pages", "256", "--epochs", "4"])
    sim = ColocationSim(CentralManager(num_pages=256, fast_capacity=32, migration_budget=8,
                                       max_tenants=8, device="cpu"), OPTANE, policy_chunk=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.OnlineTuner(sim)
    sim.run_scenario(hillclimb.skewshift_scenario(256, 2))
    tuner = hillclimb.OnlineTuner(sim, device="cpu")
    tuner.retune()
    assert tuner.retunes and tuner.device.type == "cpu"
    res = hillclimb.PolicyAutotuner("skewshift", geom, population=2, generations=1, elites=1,
                                    device="cpu").search()
    assert not res.interrupted and res.winner is not None
    assert hillclimb.main(["--scenario", "skewshift", "--pages", "256", "--epochs", "4",
                           "--population", "2", "--generations", "1", "--elites", "1",
                           "--device", "cpu"]) == 0


def test_kernel_wrappers_take_cuda_tensors_only():
    from repro_torch.kernels import flash_attention, hot_bins, page_copy, paged_attention

    pool = torch.zeros(4, 8)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        page_copy.page_move(pool, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        page_copy.page_copy(pool.clone(), pool, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        hot_bins.hot_bins(ids, torch.zeros(4, dtype=torch.int32))
    q, kp = torch.zeros(2, 4, 16), torch.zeros(8, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention(q, kp, kp, ids.reshape(2, 1), ids)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16),
                                        torch.zeros(1, 2, 8, 16))


def test_dispatch_is_by_device_with_no_override(monkeypatch):
    from repro_torch.kernels import ops

    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    before = ops.launch_counts()
    pool = torch.arange(12.0).reshape(4, 3)
    out = ops.page_move(pool, torch.tensor([0], dtype=torch.int32),
                        torch.tensor([2], dtype=torch.int32))
    assert out[2].tolist() == [0.0, 1.0, 2.0]
    assert ops.launch_counts() == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="no kernel"):
        ops.page_move(torch.zeros(2, 2, device="meta"), torch.zeros(1, dtype=torch.int32),
                      torch.zeros(1, dtype=torch.int32))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.build(["page_copy"])
    assert not (tmp_path / "build").exists()


def test_smoke_reads_the_ptxas_report():
    """The build keeps nvcc's -Xptxas -v report beside each library;
    ``chip_smoke.ptxas_report`` gives each kernel's registers, spills and
    any note that ptxas serialised its wgmma products, and
    ``template_id`` finds a kernel's instance among the mangled names."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    hopper = "_ZN12_GLOBAL__N_122flash_attention_hopperILi128EEEv14CUtensorMap_stS1_S1_S1_iiiiiiif"
    split = "_ZN12_GLOBAL__N_118paged_split_kernelI13__nv_bfloat16Li128ELi4EEEvPKT_S4_"
    found = smoke.ptxas_report(
        "ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions"
        f" are serialized due to a branch in the function '{hopper}'\n"
        f"ptxas info    : Compiling entry function '{hopper}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {hopper}\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        f"ptxas info    : Compiling entry function '{split}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 104 registers, used 1 barriers\n")
    assert found[split] == "104 registers, 0 bytes spill stores"
    assert found[hopper].startswith("168 registers, 8 bytes spill stores")
    assert "serialized" in found[hopper]
    assert smoke.template_id("flash_attention_hopper", 128) in hopper
    assert smoke.template_id("paged_split_kernel", "__nv_bfloat16", 128, 4) in split
    assert smoke.template_id("paged_split_kernel", "__nv_bfloat16", 128, 8) not in split
    assert smoke.template_id("flash_attention_kernel", "float", 128) == \
        "22flash_attention_kernelIfLi128EE"
    # a kernel that is no template, in the anonymous namespace
    mark = "_ZN12_GLOBAL__N_19move_markEPKiS1_ixPhP4int2Pii"
    assert smoke.template_id("move_mark") in mark
    assert smoke.template_id("move_pass_a") not in mark
    assert smoke.template_id("mark") not in mark


@pytest.mark.cuda
def test_cuda_request_without_a_build_raises(monkeypatch, tmp_path):
    """On the card, a kernel that cannot be built raises; nothing falls back
    to the plain version. Needs a GPU: skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to request a kernel launch")
    from repro_torch.kernels import _build, ops

    cuda = torch.device("cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if str(p).endswith("nvcc") else real_exists(p))
    pool = torch.zeros(4, 8, device=cuda)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(_build.KernelCompileError):
        ops.page_move(pool, ids, ids)
    q, kp = torch.zeros(2, 4, 16, device=cuda), torch.zeros(8, 4, 2, 16, device=cuda)
    with pytest.raises(_build.KernelCompileError):
        ops.paged_attention(q, kp, kp, ids.reshape(2, 1), ids)
    x, kv = torch.zeros(1, 4, 8, 16, device=cuda), torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(_build.KernelCompileError):
        ops.flash_attention(x, kv, kv)
