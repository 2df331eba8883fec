"""Checkpoint manager: atomic, async, keep-K, auto-resume.

Counterpart of :mod:`repro.checkpoint.manager`, with its on-disk layout:

* **Atomic commit** — writes go to ``step_XXXXXXXX.tmp/`` and are renamed
  into place only after every array and the manifest are fsynced; a
  crash mid-write never leaves a torn checkpoint discoverable.
* **Async save** — serialization runs on a background thread from a host
  snapshot (every tensor copied to host memory before ``save`` returns),
  so the train loop loses only the device-to-host copy.
* **One ``.npy`` per leaf** under its tree-path key (``/``-joined; the
  file name joins with ``__``), bfloat16 stored as its uint16 bits, and a
  ``manifest.json`` with each leaf's file, shape and dtype, the data
  pipeline's state (exactly-once resume) and ``extra``.
* **Keep-K GC** and ``latest`` discovery for auto-resume.

A state is a nested dict whose leaves are tensors, Python ints (stored as
0-d int32 arrays, as the reference's step counters), None (skipped, as
JAX skips it) or a :class:`torch.nn.Module`, whose parameters are leaves
under their state-dict names (``params/blocks.0.attn.wq``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs of a state in order; a module's parameters by
    state-dict name."""
    if isinstance(tree, torch.nn.Module):
        return [(prefix + n, p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_flatten(v, f"{prefix}{k}/"))
        return out
    if tree is None:
        return []
    return [(prefix.rstrip("/"), tree)]


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (a snapshot: later writes to
    the tensor, also on the CPU, do not reach it); bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (bool, int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, (bool, int, np.integer)):
        return "int32"
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, data_state: dict | None = None,
             extra: dict | None = None) -> None:
        """Snapshot to host, then (optionally async) commit to disk."""
        self.wait()   # one in-flight save at a time
        host = [(key, _to_host(leaf), _dtype_name(leaf)) for key, leaf in _flatten(state)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._commit, args=(step, host, data_state, extra), daemon=True)
            self._thread.start()
        else:
            self._commit(step, host, data_state, extra)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _commit(self, step: int, host: list, data_state, extra) -> None:
        try:
            final = self.dir / f"step_{step:08d}"
            tmp = self.dir / f"step_{step:08d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)

            manifest = {"step": step, "time": time.time(), "leaves": {},
                        "data_state": data_state, "extra": extra or {}}
            for key, arr, dtype_name in host:
                fname = key.replace("/", "__") + ".npy"
                with open(tmp / fname, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                           "dtype": dtype_name}
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())

            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)            # atomic commit
            self._gc()
        except BaseException as e:  # noqa: BLE001
            self._error = e

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        """Every leaf of a checkpoint as a host array by key (bf16 leaves
        as their uint16 bits), and the manifest."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        return {key: np.load(d / info["file"]) for key, info in manifest["leaves"].items()}, \
            manifest

    def restore(self, step: int, like) -> tuple[Any, dict | None]:
        """Restore into the structure of ``like`` (a state of the same
        tree).  Returns (state, data_state): a new nested dict with new
        tensors on each ``like`` leaf's device and in its dtype, ints as
        ints, and each module of ``like`` itself, its parameters
        overwritten in place.  A leaf whose shape differs from ``like``'s
        raises ``ValueError`` before anything is written."""
        arrays, manifest = self.read(step)
        info = manifest["leaves"]

        def load(key: str, ref):
            if key not in info:
                raise KeyError(f"checkpoint step {step} has no leaf {key}")
            arr = arrays[key]
            if info[key]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.as_tensor(arr)
            want = tuple(ref.shape) if isinstance(ref, torch.Tensor) else ()
            if tuple(t.shape) != want:
                raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(t.shape)} "
                                 f"vs expected {want}")
            return t

        for key, ref in _flatten(like):       # every shape first
            load(key, ref)

        def build(tree, prefix: str = ""):
            if isinstance(tree, torch.nn.Module):
                with torch.no_grad():
                    for n, p in tree.named_parameters():
                        p.copy_(load(prefix + n, p))
                return tree
            if isinstance(tree, dict):
                return {k: build(v, f"{prefix}{k}/") for k, v in tree.items()}
            if tree is None:
                return None
            key = prefix.rstrip("/")
            t = load(key, tree)
            if isinstance(tree, torch.Tensor):
                return t.to(device=tree.device, dtype=tree.dtype)
            return int(t)

        return build(like), manifest.get("data_state")

    def restore_latest(self, like) -> tuple[Optional[int], Any, dict | None]:
        step = self.latest_step()
        if step is None:
            return None, None, None
        state, ds = self.restore(step, like)
        return step, state, ds
