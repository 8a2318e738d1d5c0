"""Atomic, asynchronous, location-aware checkpoints (the port of
``repro.train.checkpoint``), in the reference's format on disk.

Layout (one directory per step)::

    <dir>/step_000010/
        manifest.json        # {"step", "keys": {path: {"shape", "dtype"}}}
        arrays.npz           # one array per key ("/" written as "__")
    <dir>/LATEST             # atomically-updated pointer

The key paths, dtype strings and storage are the reference's, so a
checkpoint of either package restores through the other's ``restore``:
trees are nested dicts (lists and tuples by index), flattened to
"/"-joined paths; bfloat16 is stored as its ``uint16`` bit pattern with
``"bfloat16"`` in the manifest and read back without ``ml_dtypes``. The
training loop writes ``{"p": params, "o": opt_state}`` in the reference's
stacked layout (``repro_torch._bridge.to_reference``).

* **atomic**: writes go to ``step_N.tmp`` then ``os.rename``; ``LATEST`` is
  replaced with ``os.replace``;
* **async**: ``save_async`` copies every tensor to host memory on the
  caller's thread and writes on a background thread, one write in flight;
* **location-aware**: given a :class:`~repro_torch.core.locstore.LocStore`,
  each checkpoint registers its placement (writer node, path, size, step).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.locstore import LocStore

_SEP = "/"
_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "uint8": torch.uint8, "bool": torch.bool}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves by "/"-joined path, dict keys in sorted order (as
    ``jax.tree_util`` flattens a dict), list and tuple items by index."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix.rstrip(_SEP): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    return out


def _to_host(x: Any) -> tuple[np.ndarray, str]:
    """A leaf as (a numpy array numpy can store, the manifest's dtype
    string), copied: a tensor's bytes never alias the caller's."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.array(x)
    name = str(a.dtype)
    if a.dtype.str.lstrip("<>|=") not in (
            "f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8",
            "b1"):
        a = a.view(_UINT[a.dtype.itemsize])      # ml_dtypes (bf16, fp8 ...)
    return a, name


def _host_flat(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {k: _to_host(v) for k, v in _flatten(tree).items()}


def _write(flat: dict[str, tuple[np.ndarray, str]], directory: str,
           step: int, store: LocStore | None, node: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step,
                "keys": {k: {"shape": list(a.shape), "dtype": dt}
                         for k, (a, dt) in flat.items()}}
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace(_SEP, "__"): a for k, (a, _) in flat.items()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    ptr = os.path.join(directory, "LATEST.tmp")
    with open(ptr, "w") as f:
        f.write(os.path.basename(final))
    os.replace(ptr, os.path.join(directory, "LATEST"))
    if store is not None:
        size = sum(a.nbytes for a, _ in flat.values())
        name = f"ckpt:{os.path.basename(directory)}:{step}"
        if store.exists(name):
            store.delete(name)
        store.put(name, memoryview(b""), loc=node,
                  xattr={"path": final, "size": size, "step": step})
    return final


def save(tree: Any, directory: str, step: int, *,
         store: LocStore | None = None, node: int = 0) -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays);
    returns the checkpoint path."""
    return _write(_host_flat(tree), directory, step, store, node)


class AsyncCheckpointer:
    """Snapshot to host memory on the caller's thread, write on a background
    thread. ``wait()`` joins the write in flight and raises its error (call
    it before shutdown; ``save_async`` calls it first, so at most one write
    is in flight)."""

    def __init__(self, directory: str, *, store: LocStore | None = None,
                 node: int = 0) -> None:
        self.directory = directory
        self.store = store
        self.node = node
        self._thread: threading.Thread | None = None
        self.last_path: str | None = None
        self._error: BaseException | None = None

    def save_async(self, tree: Any, step: int) -> None:
        self.wait()
        flat = _host_flat(tree)

        def work():
            try:
                self.last_path = _write(flat, self.directory, step,
                                        self.store, self.node)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="xflow-ckpt")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def _leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype (bfloat16 from
    its uint16 bits)."""
    if dtype not in _TORCH_DTYPES:
        raise TypeError(f"checkpoint dtype {dtype!r} has no torch dtype here")
    t = torch.from_numpy(np.ascontiguousarray(arr))
    want = _TORCH_DTYPES[dtype]
    if t.dtype != want:
        t = t.view(want)            # the same width: a uint view of bf16
    return t


def restore(directory: str, step: int | None = None, *,
            target: Any | None = None) -> Any:
    """Load a checkpoint as a nested dict of CPU tensors. With ``target``
    (a tree of tensors, meta tensors included) the key sets must match;
    each leaf is cast to the target's dtype, placed on its device (the host
    for a meta target) and the target's structure is returned."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: _leaf(data[k.replace(_SEP, "__")], meta["dtype"])
                for k, meta in manifest["keys"].items()}
    if target is None:
        out: dict[str, Any] = {}
        for k, v in flat.items():
            cur = out
            parts = k.split(_SEP)
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = v
        return out
    t_flat = _flatten(target)
    if set(t_flat) != set(flat):
        raise ValueError(f"checkpoint/target mismatch: "
                         f"{sorted(set(t_flat) ^ set(flat))}")

    def place(key: str, tgt: torch.Tensor) -> torch.Tensor:
        arr = flat[key]
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)}, "
                             f"target {tuple(tgt.shape)}")
        dev = "cpu" if tgt.device.type == "meta" else tgt.device
        return arr.to(device=dev, dtype=tgt.dtype)

    def rebuild(tree: Any, prefix: str = "") -> Any:
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}{_SEP}")
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}{_SEP}")
                              for i, v in enumerate(tree))
        key = prefix.rstrip(_SEP)
        return place(key, tree)

    return rebuild(target)
