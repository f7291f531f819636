"""Fault-tolerant checkpointing: atomic, resumable, elastic, asynchronous.
Counterpart of ``repro/training/checkpoint.py``, in its file format, so that
a checkpoint written by either package restores in the other:

* ``<dir>/step-%09d/state.npz`` holds every leaf as a numpy array, keyed
  ``params/...`` and ``opt/...`` with the tree path joined by ``/``, a list
  index written ``#i`` and an int8 moment as ``.../q`` and ``.../scale``;
  ``meta.json`` beside it holds the step and the number of leaves.  A bf16
  leaf is stored as the reference stores it, two raw bytes per element (a
  ``|V2`` array), and read back from its bits;
* atomic — a snapshot is written to ``<dir>/tmp-<step>`` and renamed to
  ``step-...`` only when complete, so a crashed save never corrupts the
  latest good checkpoint; the oldest are removed down to ``keep``;
* resumable — ``latest_step`` / ``restore`` let ``launch/train.py`` resume
  after a failure; the data pipeline is a pure function of the step, so the
  resumed run consumes the same batches;
* elastic — ``restore(..., shardings=(param specs, opt specs))`` places
  each leaf onto the current mesh as a DTensor, so a checkpoint written on
  N ranks restores on M (the file holds whole leaves);
* async — ``save(..., blocking=False)`` copies the leaves to host memory at
  once and writes them to disk on a background thread; ``wait`` joins it.

Under a process group of several ranks every rank calls ``save``: each
gathers the DTensor leaves whole (``full_tensor``, a collective) before any
thread starts, since no collective runs in the writer thread, and only rank
0 writes.  A blocking save ends in a barrier, so every rank sees the
published step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..tree import tree_unflatten

__all__ = ["CheckpointManager"]

_SEP = "/"


def _items(tree: Any, path: Tuple[str, ...] = ()):
    """(key, leaf) pairs, the key the reference's path string."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, path + (f"#{i}",))
    else:
        yield _SEP.join(path), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the leaf: an async write outlives it);
    a DTensor is gathered whole first."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_torch(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # raw bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _items(tree)}


def _unflatten(template: Any, flat: Dict[str, np.ndarray], device) -> Any:
    leaves = []
    for key, tmpl in _items(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(tmpl.shape)}")
        dev = tmpl.device if device is None else device
        leaves.append(_to_torch(arr, tmpl.dtype, dev))
    return tree_unflatten(template, leaves)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- write -------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any, blocking: bool = True):
        flat = {"params" + _SEP + k: v for k, v in _flatten(params).items()}
        flat.update({"opt" + _SEP + k: v for k, v in _flatten(opt_state).items()})
        self.wait()
        many = dist.is_initialized() and dist.get_world_size() > 1
        if many and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return
        if blocking:
            self._write(step, flat)
            if many:
                dist.barrier()
        else:
            self._thread = threading.Thread(target=self._write, args=(step, flat))
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray]):
        tmp = os.path.join(self.dir, f"tmp-{step}")
        final = os.path.join(self.dir, f"step-{step:09d}")
        if os.path.exists(final):
            return  # idempotent: this step was already published atomically
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(flat)}, f)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:09d}"), ignore_errors=True)

    # ---- read ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(name.split("-")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step-"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, params_template: Any, opt_template: Any,
                device=None, shardings: Optional[Tuple[Any, Any]] = None
                ) -> Tuple[Any, Any]:
        """The checkpoint of ``step`` in the templates' structure, each leaf
        in its template's dtype, on ``device`` (default: each template
        leaf's own device; a ``meta`` template needs a device).  With
        ``shardings`` = (param specs, opt-state specs) the leaves are placed
        onto the mesh of ``sharding.use_mesh`` as DTensors with those specs:
        the elastic restore."""
        path = os.path.join(self.dir, f"step-{step:09d}", "state.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        pre_p, pre_o = "params" + _SEP, "opt" + _SEP
        pf = {k[len(pre_p):]: v for k, v in flat.items() if k.startswith(pre_p)}
        of = {k[len(pre_o):]: v for k, v in flat.items() if k.startswith(pre_o)}
        params = _unflatten(params_template, pf, device)
        opt_state = _unflatten(opt_template, of, device)
        if shardings is None:
            return params, opt_state
        from ..distribution import sharding

        mesh = sharding.current()["mesh"]
        return (sharding.distribute(params, shardings[0], mesh),
                sharding.distribute(opt_state, shardings[1], mesh))
