"""Atomic, asynchronous checkpointing of the trainer's state, the
reference's ``checkpoint/checkpointer.py`` on PyTorch.

Layout (one directory per step, a manifest and one .npy per leaf):

    <dir>/step_00000120/
        MANIFEST.json   {step, leaves: {path: {file, shape, dtype, shard}}, meta}
        <leafpath>.npy

Writes go to ``tmp.<step>`` and are atomically renamed: a crash in the
middle of a save never corrupts the latest checkpoint. The snapshot to host
memory is synchronous; the files are written on a background thread
(training goes on while the previous step serialises), and ``wait()``
joins it. ``keep`` bounds the step directories kept.

Two differences from the reference's format, forced by the machine with the
card, which has neither ``msgpack`` nor ``ml_dtypes``:
  * the manifest is JSON (``MANIFEST.json``), not msgpack;
  * a bfloat16 leaf is stored as its ``uint16`` view, with "bfloat16" as its
    dtype in the manifest, and restored bit for bit.
The reference's checkpoints are not read. Leaf paths are the reference's:
NamedTuple fields in order, dict keys sorted, joined with "." (a ``None``
subtree has no leaves).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _unflatten(target, leaves: Dict[str, Any], prefix: str = ""):
    def sub(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if target is None:
        return None
    if _is_namedtuple(target):
        return type(target)(*(_unflatten(v, leaves, sub(k)) for k, v in zip(target._fields,
                                                                           target)))
    if isinstance(target, dict):
        return {k: _unflatten(v, leaves, sub(k)) for k, v in target.items()}
    return leaves[prefix]


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to save, dtype name) of one leaf, a copy in host memory (the
    train step updates the state in place while the write runs); bf16 as
    its uint16 view."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), "bfloat16"
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    """The saved array as a tensor of ``like``'s dtype on its device."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Any, meta: Optional[Dict] = None,
             blocking: bool = False) -> None:
        # snapshot to host memory synchronously, serialise in the background
        leaves = {name: _to_host(leaf) for name, leaf in _flatten(state)}
        self.wait()
        self._pending = self._pool.submit(self._write, step, leaves, meta or {})
        if blocking:
            self.wait()

    def _write(self, step: int, leaves: Dict[str, Tuple[np.ndarray, str]], meta: Dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "meta": meta, "leaves": {}}
        for name, (arr, dtype) in leaves.items():
            fn = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": dtype,
                "shard": {"offset": [0] * arr.ndim, "global_shape": list(arr.shape)},
            }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``target`` (tensor leaves); each
        leaf takes the target leaf's dtype and device. Returns (state,
        meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for name, leaf in _flatten(target):
            ent = manifest["leaves"].get(name)
            if ent is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = np.load(os.path.join(d, ent["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: shape {arr.shape} != target {tuple(leaf.shape)}")
            leaves[name] = _from_host(arr, ent["dtype"], leaf)
        return _unflatten(target, leaves), manifest["meta"]
