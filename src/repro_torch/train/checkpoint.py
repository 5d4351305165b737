"""Fault-tolerant checkpointing: atomic snapshots, keep-last-k, auto-resume.

Format: one ``step_<N>.ckpt`` file per snapshot, ``torch.save`` of
``{"step", "fingerprint", "leaves"}``: the tree's leaves copied to the CPU
in tree order, and a fingerprint of the tree's key paths, shapes and
dtypes.  It is written to a temporary file, flushed to disk and renamed
into place, so a crash mid-write never corrupts the latest checkpoint.
A restore reads it with ``torch.load(weights_only=True)`` (no code is
unpickled), checks the fingerprint against the tree it restores into and
puts each leaf on that tree's leaf's device.  bfloat16 round-trips as it
is.

The reference writes msgpack (with ``ml_dtypes`` for bfloat16); the two
packages' checkpoint files are not interchangeable (ROADMAP.md, queue 3).
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util

_NAME = re.compile(r"step_(\d+)\.ckpt")


def fingerprint(tree: Any) -> str:
    """Key paths, shapes and dtypes of the tree's leaves, in tree order."""
    return ";".join(
        f"{'/'.join(map(str, path))}:{tuple(leaf.shape)}:{leaf.dtype}"
        for path, leaf in tree_util.flatten(tree))


def save_checkpoint(path: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` to ``<path>/step_<step>.ckpt``."""
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(step), "fingerprint": fingerprint(tree),
               "leaves": [leaf.detach().cpu()
                          for leaf in tree_util.leaves(tree)]}
    final = os.path.join(path, f"step_{step:012d}.ckpt")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)          # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return final


def latest_checkpoint(path: str) -> Optional[str]:
    if not os.path.isdir(path):
        return None
    steps = sorted((int(m.group(1)), name) for name in os.listdir(path)
                   if (m := _NAME.fullmatch(name)))
    return os.path.join(path, steps[-1][1]) if steps else None


def restore_checkpoint(file: str, like: Any):
    """``(step, tree)``: the snapshot in ``like``'s structure, each leaf on
    the device of ``like``'s leaf.  Raises ``ValueError`` when the saved
    tree's key paths, shapes or dtypes differ from ``like``'s."""
    payload = torch.load(file, map_location="cpu", weights_only=True,
                         mmap=True)
    if payload["fingerprint"] != fingerprint(like):
        raise ValueError(
            "checkpoint tree mismatch -- incompatible model/opt config")
    leaves = [saved.to(cur.device) for saved, cur in
              zip(payload["leaves"], tree_util.leaves(like))]
    return payload["step"], tree_util.unflatten(like, leaves)


def prune_checkpoints(path: str, keep: int) -> None:
    if not os.path.isdir(path):
        return
    files = sorted(f for f in os.listdir(path) if _NAME.fullmatch(f))
    for f in files[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(path, f))
