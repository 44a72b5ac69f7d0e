"""The port's sharding rules and spec builders against the reference's, pure
host (no process group): every architecture x its applicable shapes x the
four meshes (test, test multi-pod, production, production multi-pod).

The reference's builders run on a device-free
``jax.sharding.AbstractMesh``, the port's on ``launch.mesh.MeshShape``;
``rules_for``, every parameter's spec (path by path), the batch specs, the
decode-cache specs and the train-state specs must be equal as tuples. The
port's trees are built under ``FakeTensorMode`` (nothing allocated), the
reference's under ``jax.eval_shape``. Also: ``logical_spec``'s unit cases,
and ``model.input_specs`` (shapes and dtypes) against the reference's.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jcfg
from repro.launch import partitioning as jpart
from repro.launch import shardings as jsh
from repro.models.model import get_model as jget_model
from repro.models.model import input_specs as jinput_specs
from repro.training.train_state import init_train_state as jinit_train_state
from repro_torch import configs as tcfg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import partitioning as tpart
from repro_torch.launch import shardings as tsh
from repro_torch.models.model import get_model, input_specs
from repro_torch.training.train_state import init_train_state

MESHES = [(kind, mp) for kind in ("test", "prod") for mp in (False, True)]
CELLS = [(arch, s.name) for arch in tcfg.ARCH_NAMES
         for s in tcfg.applicable_shapes(tcfg.get_config(arch))]


def _meshes(kind, multi_pod):
    shape, names = tmesh.mesh_shape(kind, multi_pod)
    return AbstractMesh(shape, names), tmesh.MeshShape(shape, names)


def _flat_ref(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, JNamedSharding))
    return {jax.tree_util.keystr(p, simple=True, separator="/"): tuple(s.spec)
            for p, s in leaves}


def _flat_port(tree, prefix=""):
    if isinstance(tree, tpart.NamedSharding):
        return {prefix[:-1]: tuple(tree.spec)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}{k}/"))
    return out


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    cfg = jcfg.get_config(arch)
    return jax.eval_shape(lambda: jinit_train_state(cfg, jax.random.PRNGKey(0),
                                                    compress_grads=True))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    with FakeTensorMode():
        return init_train_state(tcfg.get_config(arch), 0, compress_grads=True, device="cpu")


def _caches(arch, shape):
    B, S = shape.global_batch, shape.seq_len
    ref = jax.eval_shape(lambda: jget_model(jcfg.get_config(arch)).init_cache(B, S))
    with FakeTensorMode():
        port = get_model(tcfg.get_config(arch)).init_cache(B, S, device="cpu")
    return ref, port


@pytest.mark.parametrize("kind,multi_pod", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_specs_equal_reference(arch, shape_name, kind, multi_pod):
    jmesh, pmesh = _meshes(kind, multi_pod)
    jcfg_, pcfg = jcfg.get_config(arch), tcfg.get_config(arch)
    jshape, pshape = jcfg.get_shape(shape_name), tcfg.get_shape(shape_name)

    jrules = jsh.rules_for(jcfg_, jmesh, jshape)
    prules = tsh.rules_for(pcfg, pmesh, pshape)
    assert prules == jrules
    assert tsh.rules_for(pcfg, pmesh) == jsh.rules_for(jcfg_, jmesh)

    jstate, pstate = _ref_state(arch), _port_state(arch)
    ref = _flat_ref(jsh.params_sharding(jstate.params, jmesh, jrules))
    port = _flat_port(tsh.params_sharding(pstate.params, pmesh, prules))
    assert port == ref and len(port) > 3

    ref = _flat_ref(jsh.train_state_sharding(jstate, jmesh, jrules))
    port = _flat_port(tsh.train_state_sharding(pstate, pmesh, prules))
    assert port == ref

    ref = _flat_ref(jsh.batch_specs(jcfg_, jshape, jmesh, jrules))
    port = _flat_port(tsh.batch_specs(pcfg, pshape, pmesh, prules))
    assert port == ref

    if pshape.is_decode:
        jcache, pcache = _caches(arch, pshape)
        ref = _flat_ref(jsh.cache_sharding(jcache, jcfg_, jmesh, jrules))
        port = _flat_port(tsh.cache_sharding(pcache, pcfg, pmesh, prules))
        assert port == ref


@pytest.mark.parametrize("names,rules", [
    (("batch", "seq", None), {"batch": ("data",), "seq": None}),
    (("batch", "fsdp"), {"batch": ("pod", "data"), "fsdp": ("pod", "data")}),  # dropped
    (("fsdp", "heads"), {"fsdp": ("pod", "data"), "heads": ("model",)}),  # a tuple
    (("heads", "kv_heads", "d_ff"), {"heads": "model", "kv_heads": ("model",),
                                     "d_ff": ("data", "model")}),
    ((), {}),
    ((None, "unknown"), {"batch": ("data",)}),
])
def test_logical_spec_cases(names, rules):
    assert tuple(tpart.logical_spec(names, rules)) == tuple(jpart.logical_spec(names, rules))


def test_logical_spec_drops_duplicates_and_keeps_tuples():
    spec = tpart.logical_spec(("batch", "fsdp", "heads"),
                              {"batch": ("pod", "data"), "fsdp": ("data",), "heads": "model"})
    assert spec == (("pod", "data"), None, "model")
    assert repr(spec) == "P(('pod', 'data'), None, 'model')"


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_reference(arch, shape_name):
    ref = jinput_specs(jcfg.get_config(arch), jcfg.get_shape(shape_name))
    port = input_specs(tcfg.get_config(arch), tcfg.get_shape(shape_name))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()} == {
        k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in port.items()}
