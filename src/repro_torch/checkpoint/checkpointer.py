"""Checkpointing for the fault-tolerance story:

  * atomic: write to ``step_K.tmp/`` then rename — a process dying
    mid-save never corrupts the latest restorable step;
  * async: serialization runs on a background thread, so the train loop
    only waits for the device-to-host copy of the state;
  * elastic: every leaf is stored whole (one ``.npy`` each; a DTensor
    as its ``full_tensor()``) with the tree's leaf paths, dtypes and
    shapes in a manifest, so a restart may place the state on another
    device or another mesh shape;
  * retention: keeps the last ``keep`` steps, deletes older ones.

A tree is nested dicts, lists, tuples and named tuples (the train state
``(params, AdamWState)``) over tensors or numpy arrays.  numpy has no
bfloat16, so a bfloat16 tensor is stored as its uint16 bits with
``"bfloat16"`` in the manifest: a round trip is bit-exact.
"""
from __future__ import annotations

import json
import shutil
import threading
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

_MANIFEST = "manifest.json"


def flatten(tree, prefix: str = "") -> list:
    """The (path, leaf) pairs of ``tree``: dict keys in their order,
    sequences and named tuples by position."""
    if isinstance(tree, Mapping):
        return [pair for k, v in tree.items()
                for pair in flatten(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        return [pair for name, v in zip(names, tree)
                for pair in flatten(v, f"{prefix}/{name}")]
    return [(prefix, tree)]


def unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are taken in order from
    the iterator ``leaves``."""
    leaves = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(leaves)

    return build(like)


def _whole(leaf):
    """A DTensor as its full tensor (a collective: every rank calls it),
    anything else as it is."""
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, like):
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(a)
    return a


def save_checkpoint(ckpt_dir: str | Path, step: int, tree, keep: int = 3
                    ) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    entries = []
    for i, (path, leaf) in enumerate(flatten(tree)):
        a, dtype = _to_numpy(leaf)
        np.save(tmp / f"leaf_{i}.npy", a)
        entries.append({"path": path, "dtype": dtype, "shape": list(a.shape)})
    (tmp / _MANIFEST).write_text(json.dumps(
        {"step": step, "num_leaves": len(entries), "leaves": entries}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomicity point
    for s in latest_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return final


def latest_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                  if not p.name.endswith(".tmp"))


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str | Path, step: int, like_tree):
    """Restore into the structure of ``like_tree`` (tensors come back on
    the CPU; the caller places them).  Raises ``ValueError`` when the
    checkpoint's leaf paths or shapes differ from ``like_tree``'s."""
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / _MANIFEST).read_text())
    like = flatten(like_tree)
    paths = [e["path"] for e in manifest["leaves"]]
    if paths != [p for p, _ in like]:
        raise ValueError(f"checkpoint/model structure mismatch: step {step} "
                         f"holds {len(paths)} leaves, the model "
                         f"{len(like)}")
    restored = []
    for i, (entry, (path, want)) in enumerate(zip(manifest["leaves"], like)):
        if tuple(entry["shape"]) != tuple(want.shape):
            raise ValueError(f"checkpoint/model structure mismatch at "
                             f"{path}: {entry['shape']} vs "
                             f"{list(want.shape)}")
        restored.append(_from_numpy(np.load(d / f"leaf_{i}.npy"),
                                    entry["dtype"], want))
    return unflatten(like_tree, restored)


def _host_copy(leaf):
    leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class Checkpointer:
    """Async wrapper: ``maybe_save`` returns once the state is copied to
    the host; the previous pending save is joined first (at most one in
    flight), and its error, if any, is raised there or in ``wait``."""

    def __init__(self, ckpt_dir: str | Path, every: int = 100,
                 keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _save(self, step: int, tree):
        try:
            save_checkpoint(self.dir, step, tree, keep=self.keep)
        except BaseException as exc:  # re-raised by wait()
            self._error = exc

    def maybe_save(self, step: int, tree) -> bool:
        """Every rank copies the state to the host (a DTensor whole);
        rank 0 of a process group writes it."""
        import torch.distributed as dist

        if step % self.every:
            return False
        self.wait()
        host_tree = unflatten(tree, (_host_copy(leaf)
                                     for _, leaf in flatten(tree)))
        if dist.is_initialized() and dist.get_rank() != 0:
            return True
        self._thread = threading.Thread(target=self._save,
                                        args=(step, host_tree), daemon=True)
        self._thread.start()
        return True

    def restore_latest(self, like_tree):
        step = latest_step(self.dir)
        if step is None:
            return None, 0
        return restore_checkpoint(self.dir, step, like_tree), step
