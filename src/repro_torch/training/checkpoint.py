"""Fault-tolerant checkpointing (the port of
``repro.training.checkpoint``).

  * **atomic** writes: a checkpoint directory is staged under a temp name,
    marked ``COMMITTED`` (fsynced) and renamed into place with
    ``os.replace`` only after every array and the manifest landed, so a
    preempted writer never leaves a half checkpoint under a step's name;
  * **versioned**: ``step_000420/`` directories; ``restore()`` falls back
    through older committed checkpoints when the newest is torn, and
    ``keep`` bounds how many stay on disk;
  * **async**: ``save_async`` copies every tensor to host memory first (a
    snapshot: the train loop updates its tensors in place right after),
    then writes on a background thread, so the loop never waits on the
    filesystem;
  * **elastic resharding**: on a mesh (``mesh=`` and ``placements=``, a
    tree of :class:`~repro_torch.launch.mesh.Placement` shaped as the
    saved one) every leaf is gathered whole from its shards and rank 0
    writes it, so a restart may use another mesh: ``restore(shardings=)``
    cuts each full tensor to the placement the new rank asks for.

A checkpoint is a tree of nested dicts of tensors (the model's
``state_dict()``, the optimizer's m, v and step), stored as one ``.npz``
and a JSON manifest.  numpy has no bfloat16: a bf16 tensor is stored as
its 16-bit pattern and restored bit for bit; the manifest records each
leaf's dtype.  ``restore`` returns tensors of the target tree's shapes,
dtypes and devices.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

#: dtypes numpy cannot hold, stored as integers of the same width
_BITS = {torch.bfloat16: torch.int16}


def _leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted name, leaf) of a tree of nested dicts, in insertion
    order."""
    out = []
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.extend(_leaves(val, name + "."))
        else:
            out.append((name, val))
    return out


def _unflatten(tree, values: list) -> dict:
    """A tree shaped like ``tree`` with its leaves replaced by ``values``
    (in ``_leaves`` order)."""
    it = iter(values)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(tree)


def _to_host(x) -> torch.Tensor:
    """A CPU copy of a leaf (a tensor, or a Python number): the snapshot
    that the background write reads while the loop runs on."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.tensor(x)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._last_error: Exception | None = None

    # -- paths -----------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def available_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.available_steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------
    @staticmethod
    def _snapshot(tree: dict, mesh, placements) -> list:
        """(name, full host tensor) of every leaf; on a mesh each leaf is
        gathered from its shards first (every rank takes part)."""
        if mesh is None:
            return [(n, _to_host(x)) for n, x in _leaves(tree)]
        places = dict(_leaves(placements))
        out = []
        for n, x in _leaves(tree):
            if isinstance(x, torch.Tensor) and n in places:
                x = mesh.gather_full(x.detach(), places[n])
            out.append((n, _to_host(x)))
        return out

    def save(self, step: int, tree: dict, extra: dict | None = None, *,
             mesh=None, placements: dict | None = None) -> Path | None:
        """Write ``tree`` now.  On a mesh every rank calls it; rank 0
        writes, and every rank returns once the checkpoint is there."""
        named = self._snapshot(tree, mesh, placements)
        if mesh is None:
            return self._write(step, named, extra or {})
        path = (self._write(step, named, extra or {}) if mesh.rank == 0
                else None)
        mesh.barrier()
        return path

    def save_async(self, step: int, tree: dict,
                   extra: dict | None = None, *, mesh=None,
                   placements: dict | None = None) -> None:
        """Snapshot to host memory now (gathered on a mesh, where every
        rank calls it and rank 0 writes); write on a background thread.
        On a mesh, ``wait`` and then ``mesh.barrier()`` before another
        rank reads the checkpoint."""
        self.wait()
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err
        named = self._snapshot(tree, mesh, placements)
        if mesh is not None and mesh.rank != 0:
            return

        def work():
            try:
                self._write(step, named, extra or {})
            except Exception as e:  # noqa: BLE001
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, named: list[tuple[str, torch.Tensor]],
               extra: dict) -> Path:
        final = self._step_dir(step)
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_",
                                    dir=self.dir))
        try:
            np.savez(tmp / "arrays.npz",
                     **{f"leaf_{i}": _to_numpy(t)
                        for i, (_, t) in enumerate(named)})
            manifest = {"step": step, "n_leaves": len(named),
                        "names": [n for n, _ in named],
                        "dtypes": [str(t.dtype) for _, t in named],
                        "time": time.time(), "extra": extra}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            with open(tmp / "COMMITTED", "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic on POSIX
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # clear orphaned temp dirs from crashed writers
        for p in self.dir.glob(".tmp_step_*"):
            if time.time() - p.stat().st_mtime > 3600:
                shutil.rmtree(p, ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def restore(self, target_tree: dict, step: int | None = None,
                shardings: dict | None = None
                ) -> tuple[dict, dict, int] | None:
        """Restore into the structure of ``target_tree`` (each leaf a
        tensor giving the shape, dtype and device to restore to).  With
        ``shardings`` (a tree of ``Placement`` shaped as ``target_tree``;
        a missing leaf is whole) each stored full tensor is cut to the
        rank's slice, whatever mesh wrote it.  Returns (tree, extra, step)
        or None when no usable checkpoint exists.  Falls back through
        older checkpoints on corruption."""
        candidates = ([step] if step is not None
                      else list(reversed(self.available_steps())))
        places = dict(_leaves(shardings)) if shardings is not None else {}
        for s in candidates:
            try:
                return self._read(target_tree, s, places)
            except Exception:  # noqa: BLE001 — torn checkpoint: try older
                continue
        return None

    def _read(self, target_tree: dict, step: int, places: dict):
        d = self._step_dir(step)
        if not (d / "COMMITTED").exists():
            raise FileNotFoundError(d)
        manifest = json.loads((d / "manifest.json").read_text())
        targets = _leaves(target_tree)
        if manifest["n_leaves"] != len(targets):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, target "
                f"expects {len(targets)} — incompatible structure")
        loaded = []
        with np.load(d / "arrays.npz") as data:
            for i, (name, ref) in enumerate(targets):
                arr = data[f"leaf_{i}"]
                t = torch.from_numpy(np.array(arr))
                stored = manifest["dtypes"][i]
                if stored == str(torch.bfloat16):
                    t = t.view(torch.bfloat16)
                ref = torch.as_tensor(ref)
                p = places.get(name)
                want = ref.shape if p is None else p.full_shape(ref.shape)
                if tuple(t.shape) != tuple(want):
                    raise ValueError(f"leaf {i} ({name}): shape "
                                     f"{tuple(t.shape)} != {tuple(want)}")
                if p is not None:
                    t = p.local(t)
                loaded.append(t.to(device=ref.device, dtype=ref.dtype))
        return _unflatten(target_tree, loaded), manifest["extra"], step
