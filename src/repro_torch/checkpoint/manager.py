"""Atomic checkpoints in the reference's on-disk layout.

The port of ``src/repro/checkpoint/manager.py``. Layout:
``<dir>/step_<N:08d>/manifest.json`` plus one ``.npy`` per leaf, keyed by
the leaf's path (``state/params/layers/attn/wq``; file name the path with
``/`` as ``__``), every leaf saved whole as a host array. Writes go to
``step_<N>.tmp`` and are committed by an atomic rename, so a crash
mid-save never corrupts the latest checkpoint. With the same keys,
shapes and dtypes, a checkpoint written by either package restores into
the other, bit for bit.

Host code, no torch: a leaf is anything ``numpy.asarray`` takes, or a
tensor, read through its ``detach().cpu()`` (duck-typed). ``restore``
returns numpy arrays, or hands each to ``place(array, like_leaf)``, which
the fault-tolerant loop uses to copy them into its tensors in place.

``AsyncCheckpointer`` snapshots to host memory synchronously and
serializes on a background thread. The snapshot is a copy: the port's
optimizer updates its tensors in place (``optim.adamw``), and a CPU
tensor's ``numpy()`` would share their storage with the thread still
writing them.

Sharded state: a DTensor leaf (duck-typed, ``full_tensor``) is gathered
whole on every rank, on the caller's thread, before anything is written
(so no collective ever runs on the writer thread); rank 0 alone writes,
and the ranks meet at a barrier once the checkpoint is committed (at the
end of ``save``; in ``AsyncCheckpointer.wait``). The files are the same
as an unsharded state's, so a checkpoint crosses between meshes, device
counts and the two packages. ``restore(..., shardings=)`` distributes
each restored array onto the current mesh (``partition.Sharding``s, the
reference's ``NamedSharding``s).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Callable, Optional

import numpy as np

from repro_torch import pytree


def _host(leaf, copy: bool = False) -> np.ndarray:
    """``leaf`` as a host array (a copy where ``copy``); a DTensor is
    gathered whole first (a collective)."""
    if hasattr(leaf, "full_tensor"):  # a DTensor
        leaf = leaf.full_tensor()
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        on_host = leaf.device.type == "cpu"
        leaf = leaf.detach().cpu().numpy()  # off the host, already a copy
        copy = copy and on_host
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _flatten(tree, copy: bool = False) -> dict[str, np.ndarray]:
    return {key: _host(leaf, copy) for key, leaf in pytree.items(tree)}


def _sharded(tree) -> bool:
    """Whether ``tree`` holds a DTensor: its save is a collective."""
    return any(hasattr(leaf, "full_tensor") for _, leaf in pytree.items(tree))


def _rank() -> int:
    import torch.distributed as dist  # only reached for a sharded state
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def save(tree, directory: str, step: int) -> str:
    """Atomic synchronous save. Returns the committed path. A sharded
    tree is gathered on every rank, written by rank 0, and every rank
    returns once it is committed."""
    if _sharded(tree):
        flat = _flatten(tree)
        if _rank() == 0:
            _write(flat, directory, step)
        _barrier()
        return os.path.join(directory, f"step_{step:08d}")
    return _write(_flatten(tree), directory, step)


def _write(flat: dict, directory: str, step: int) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for key, arr in flat.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "shard_spec": None,  # per-shard layout hook for multi-host
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(like_tree, directory: str, step: Optional[int] = None,
            place: Optional[Callable] = None, shardings=None):
    """Restore into the structure of ``like_tree``; returns ``(tree,
    step)``. Each leaf is the saved array, or ``place(array, like_leaf)``
    where ``place`` is given. ``shardings`` (a tree of ``like_tree``'s
    structure holding ``partition.Sharding``s; None at a subtree keeps
    its leaves host arrays) re-shards onto the current mesh: elastic
    across device counts."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for key, like in pytree.items(like_tree):
        arr = np.load(os.path.join(path, manifest["leaves"][key]["file"]))
        flat[key] = arr if place is None else place(arr, like)
    tree = _unflatten(like_tree, flat)
    if shardings is not None:
        tree = _reshard(tree, shardings)
    return tree, step


def _reshard(tree, shardings):
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _reshard(v, shardings[k]) for k, v in tree.items()}
    from repro_torch.distributed import partition
    return partition.place(tree, shardings)


def _unflatten(like_tree, flat: dict, prefix: str = ""):
    if not isinstance(like_tree, dict):
        return flat[prefix]
    return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like_tree.items()}


class AsyncCheckpointer:
    """Snapshot synchronously, serialize in the background, keep the
    newest ``keep``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sync = False  # the outstanding save was a sharded state's

    def save(self, tree, step: int):
        self.wait()  # one outstanding save at a time
        host_tree = _unflatten(tree, _flatten(tree, copy=True))  # snapshot
        self._sync = _sharded(tree)
        if self._sync and _rank() != 0:
            return  # rank 0 writes; wait() meets it at the barrier

        def work():
            try:
                _write(_flatten(host_tree), self.directory, step)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sync:
            self._sync = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.directory) if d.startswith("step_")
            and not d.endswith(".tmp")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))
