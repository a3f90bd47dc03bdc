"""Sharded, atomic, async checkpointing — the reference's
``repro/checkpoint/manager.py`` protocol on trees of torch tensors.

Semantics borrowed from the paper's §III.B "keep both outputs" rule: a
speculative (shadow) writer and the primary may BOTH complete a step's
checkpoint; both directories are retained until the commit barrier picks
the first valid one — only then are losers garbage-collected. Commits are
atomic (`os.rename` of a finished tmp dir), so a writer dying mid-save can
never corrupt the latest checkpoint; restart always finds the newest
manifest-complete step.

Layout:
    <dir>/step_000042/            committed
    <dir>/step_000042.tmp-<tag>/  in-flight writer (primary or shadow)
    each dir: manifest.json + one .npy per tree leaf

A tree is nested dicts, lists and tuples whose leaves are torch tensors,
numpy arrays or numbers; leaves are flattened in one fixed order (dict
keys sorted, list entries by index) and named by ``/``-joined paths, as
the reference flattens its pytrees. numpy has no bfloat16 without
``ml_dtypes``, which the port does not need: a bfloat16 leaf is written
as its ``uint16`` bits and its dtype is recorded in the manifest, so it
restores bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{9})$")
_BF16 = "bfloat16"


def _leaf_paths(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, Mapping):
            items = [(str(k), node[k]) for k in sorted(node)]
        elif isinstance(node, (list, tuple)):
            items = [(str(i), x) for i, x in enumerate(node)]
        else:
            out.append((prefix, node))
            return
        for name, child in items:
            walk(child, f"{prefix}/{name}" if prefix else name)

    walk(tree, "")
    return out


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(like)


class _HostLeaf:
    """A leaf already copied to host memory by :func:`_to_numpy`."""

    __slots__ = ("arr", "dtype")

    def __init__(self, arr: np.ndarray, dtype: Optional[str]):
        self.arr, self.dtype = arr, dtype


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy of one leaf, and its dtype name when numpy cannot hold
    it (bfloat16: the uint16 bits)."""
    if isinstance(leaf, _HostLeaf):
        return leaf.arr, leaf.dtype
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.array(leaf), None


def _fsync_path(path: str) -> None:
    """Best-effort fsync of a file or directory (directory fsync pins the
    rename/creation in the parent's metadata — required for the commit to
    survive power loss, not just process death)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fs without fsync support
        pass
    finally:
        os.close(fd)


def save_pytree(dirpath: str, tree: Any, *, step: int,
                metadata: Optional[Dict[str, Any]] = None,
                tag: str = "primary", fsync: bool = True) -> str:
    """Write one checkpoint dir atomically; returns the committed path.
    If another writer already committed this step, keeps ours as a shadow
    copy (``step_N.shadow-<tag>``) — both outputs retained (§III.B).

    Crash-safe write discipline (DESIGN.md §16.7): every leaf and the
    manifest are flushed+fsynced inside the tmp dir, the tmp dir itself is
    fsynced, THEN the atomic rename commits, then the parent dir is
    fsynced. A writer dying (or machine losing power) at any point leaves
    either the complete previous state or a ``.tmp-`` orphan that
    ``CheckpointManager`` sweeps on startup — never a torn checkpoint.
    The manifest is written last, so its presence certifies every leaf.
    """
    final = os.path.join(dirpath, f"step_{step:09d}")
    tmp = final + f".tmp-{tag}"
    os.makedirs(tmp, exist_ok=True)
    names, dtypes = {}, {}
    for i, (key, leaf) in enumerate(_leaf_paths(tree)):
        fname = f"leaf_{i:05d}.npy"
        names[fname] = key
        arr, dtype = _to_numpy(leaf)
        if dtype is not None:
            dtypes[fname] = dtype
        fpath = os.path.join(tmp, fname)
        with open(fpath, "wb") as f:
            np.save(f, arr)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
    manifest = {"step": step, "leaves": names, "dtypes": dtypes, "tag": tag,
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if fsync:
        _fsync_path(tmp)
    try:
        os.rename(tmp, final)
        committed = final
    except OSError:
        shadow = final + f".shadow-{tag}"
        shutil.rmtree(shadow, ignore_errors=True)
        os.rename(tmp, shadow)
        committed = shadow
    if fsync:
        _fsync_path(dirpath)
    return committed


def _restore_leaf(arr: np.ndarray, dtype: Optional[str], ref: Any) -> Any:
    if dtype == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = None
    if isinstance(ref, torch.Tensor):
        if t is None:
            t = torch.from_numpy(arr)
        return t.to(device=ref.device, dtype=ref.dtype)
    if t is not None:
        raise TypeError("a bfloat16 leaf restores into a torch tensor only")
    if hasattr(ref, "dtype"):
        arr = arr.astype(ref.dtype, copy=False)
    return arr


def restore_pytree(dirpath: str, like: Any, *, step: Optional[int] = None
                   ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore the newest (or given) committed step into ``like``'s
    structure: torch leaves of ``like`` come back as tensors of their
    dtype on their device, numpy leaves as arrays of their dtype.
    Returns (tree, step, metadata)."""
    if step is None:
        steps = sorted(
            int(m.group(1)) for m in
            (_STEP_RE.match(d) for d in os.listdir(dirpath)) if m)
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints in {dirpath}")
        step = steps[-1]
    d = os.path.join(dirpath, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    out = []
    for i, (key, ref) in enumerate(_leaf_paths(like)):
        fname = f"leaf_{i:05d}.npy"
        if manifest["leaves"].get(fname) != key:
            raise ValueError(f"checkpoint step {step}: {fname} holds "
                             f"{manifest['leaves'].get(fname)!r}, the tree "
                             f"wants {key!r}")
        arr = np.load(os.path.join(d, fname))
        out.append(_restore_leaf(arr, dtypes.get(fname), ref))
    return _unflatten(like, out), step, manifest.get("metadata", {})


class CheckpointManager:
    """Async save + retention + commit-barrier GC of shadow copies."""

    def __init__(self, dirpath: str, *, keep: int = 3):
        self.dir = dirpath
        self.keep = keep
        os.makedirs(dirpath, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sweep_stale_tmps()

    def _sweep_stale_tmps(self) -> None:
        """Startup recovery: a ``.tmp-`` dir is a writer that died mid-save
        (possibly torn — no manifest, partial leaves); it can never be
        restored from, so it is removed. Shadow copies are committed
        (manifest-complete) and stay until the normal commit-barrier GC."""
        for d in os.listdir(self.dir):
            if ".tmp-" in d:
                shutil.rmtree(os.path.join(self.dir, d),
                              ignore_errors=True)

    # -- writing --------------------------------------------------------
    def save(self, tree: Any, step: int, *, tag: str = "primary",
             metadata: Optional[Dict[str, Any]] = None) -> str:
        path = save_pytree(self.dir, tree, step=step, tag=tag,
                           metadata=metadata)
        self._gc(step)
        return path

    def save_async(self, tree: Any, step: int, *, tag: str = "primary",
                   metadata: Optional[Dict[str, Any]] = None) -> None:
        """Copy every leaf to host memory on the caller's thread, write on
        a background thread — training continues during the disk write."""
        self.wait()
        paths = _leaf_paths(tree)
        snap = _unflatten(tree, [_HostLeaf(*_to_numpy(leaf))
                                 for _key, leaf in paths])

        def work():
            try:
                self.save(snap, step, tag=tag, metadata=metadata)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- reading --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(m.group(1)) for m in
                 (_STEP_RE.match(d) for d in os.listdir(self.dir)) if m]
        return max(steps) if steps else None

    def restore(self, like: Any, *, step: Optional[int] = None):
        self.wait()
        return restore_pytree(self.dir, like, step=step)

    # -- retention ------------------------------------------------------
    def _gc(self, newest_step: int) -> None:
        """Commit barrier: once step N is committed, shadow/tmp copies of
        steps ≤ N have lost the race and old steps beyond ``keep`` go."""
        for d in os.listdir(self.dir):
            full = os.path.join(self.dir, d)
            if ".shadow-" in d or ".tmp-" in d:
                try:
                    s = int(d.split("step_")[1].split(".")[0])
                except (IndexError, ValueError):
                    continue
                if s <= newest_step - 1:
                    shutil.rmtree(full, ignore_errors=True)
        steps = sorted(int(m.group(1)) for m in
                       (_STEP_RE.match(d) for d in os.listdir(self.dir))
                       if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
