"""Integrity-checked checkpointing (twin of
``repro/checkpoint/checkpointer.py``), with the same on-disk layout::

    <dir>/step_000123/
        manifest.json      # leaves (shape, dtype), sha256 per file, extra
        shard_0.npz        # one entry per leaf, keyed by its '/'-joined path

Trees are the port's nested dicts and lists of tensors, flattened by
``models.param.flatten`` (dict keys sorted, list entries by index), so a
tree's paths read like the JAX package's. Saving writes into a temporary
directory and renames it into place (atomic publish); with
``async_save`` a background thread writes a host copy while training goes
on, and ``wait()`` joins it before the next save. Restore verifies the
sha256 and puts each leaf on the device and in the dtype of the tree it
restores into. bfloat16 leaves are stored as their int16 bits.

On a mesh (``distributed/sharding.py``) a tree of the ranks' slices is
saved whole: ``save(..., shardings=)`` gathers the whole leaves, rank 0
writes and every rank waits for it. ``restore(like, mesh=)`` is JAX's
elastic restore: each rank keeps its slices of the whole leaves by
``params_shardings`` on ``mesh`` (which may differ from the mesh that
saved them), under the active rules and fsdp flag.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh
from repro_torch.models import param as pm


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy()


def _from_numpy(a: np.ndarray, like) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    if not isinstance(like, torch.Tensor):
        return t
    if like.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save ---
    def save(self, step: int, tree, extra: Optional[Dict] = None,
             shardings=None):
        """Write ``tree`` as step ``step``. ``shardings`` (a tree of
        ``sharding.LeafShard``, inside a mesh): ``tree`` holds this rank's
        slices; every rank calls this, the whole leaves are gathered, rank
        0 writes and all wait for it (collective; never in the
        background)."""
        self.wait()
        if shardings is not None:
            tree = sh.gather_tree(tree, shardings)
            if dist.get_rank() == 0:
                flat = pm.flatten(tree)
                self._write(step, {k: _to_numpy(v) for k, v in flat.items()},
                            {k: str(v.dtype).replace("torch.", "")
                             for k, v in flat.items()}, extra)
            dist.barrier()
            return
        flat = pm.flatten(tree)
        host = {k: _to_numpy(v) for k, v in flat.items()}
        dtypes = {k: str(torch.as_tensor(v).dtype).replace("torch.", "")
                  for k, v in flat.items()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, dtypes, extra),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, dtypes, extra)

    def _write(self, step: int, flat, dtypes, extra):
        out = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        tmp.mkdir(parents=True, exist_ok=True)
        shard_file = tmp / "shard_0.npz"
        np.savez(shard_file, **flat)
        sha = hashlib.sha256(shard_file.read_bytes()).hexdigest()
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
            "files": {"shard_0.npz": sha},
            "extra": extra or {},
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)          # atomic publish

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------------------------------------------------- restore ---
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if p.is_dir())
        return steps[-1] if steps else None

    def restore(self, like_tree, step: Optional[int] = None, mesh=None):
        """Restore into the structure, devices and dtypes of ``like_tree``.
        With ``mesh`` (a rank's view of a mesh), each leaf is this rank's
        slice of the saved whole leaf by ``params_shardings`` on ``mesh``
        (``like_tree`` may hold whole leaves or slices). Returns (tree,
        extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        shard_file = d / "shard_0.npz"
        sha = hashlib.sha256(shard_file.read_bytes()).hexdigest()
        if sha != manifest["files"]["shard_0.npz"]:
            raise ValueError("checkpoint corrupted (sha mismatch)")
        flat_like = pm.flatten(like_tree)
        with np.load(shard_file) as data:
            missing = [k for k in flat_like if k not in data]
            if missing:
                raise KeyError(f"missing leaves in checkpoint: {missing}")
            if mesh is None:
                flat = {k: _from_numpy(data[k], like)
                        for k, like in flat_like.items()}
            else:
                flat = {k: _from_numpy(np.ascontiguousarray(data[k][
                    sh.leaf_shard(k, data[k].shape, mesh).index]), like)
                    for k, like in flat_like.items()}
        return pm.unflatten_like(like_tree, flat), manifest.get("extra", {})
