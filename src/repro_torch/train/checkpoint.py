"""Fault-tolerant checkpointing: atomic snapshots, keep-last-k, auto-resume,
elastic resharding.

Format: one ``step_<N>.ckpt`` file per snapshot, ``torch.save`` of
``{"step", "fingerprint", "leaves"}``: the tree's leaves copied to the CPU
in tree order, and a fingerprint of the tree's key paths, shapes and
dtypes.  It is written to a temporary file, flushed to disk and renamed
into place, so a crash mid-write never corrupts the latest checkpoint.
A restore reads it with ``torch.load(weights_only=True, mmap=True)`` (no
code is unpickled), checks the fingerprint against the tree it restores
into and lays each leaf out as that tree's leaf is, or by ``shardings``.
bfloat16 round-trips as it is.

Sharded trees (:class:`~repro_torch.distributed.spmd.ShardedTensor`
leaves) are saved unsharded: each leaf's global tensor, filled on the host
from one copy of each distinct slice (:func:`spmd.gather` to ``"cpu"``), so
no device ever holds a whole leaf.  Shapes in the fingerprint are global,
so a sharded run and a single-device run of the same state write the same
file, and a restore may target another mesh shape: each position copies
its own slice of the mapped host tensor (:func:`spmd.device_put`), as the
reference ``device_put``s onto the new mesh's ``NamedSharding``s.  A
leaf's ``reads`` (the dp-only per-group views) are not saved.

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
from repro_torch.distributed import spmd

_NAME = re.compile(r"step_(\d+)\.ckpt")


def fingerprint(tree: Any) -> str:
    """Key paths, shapes and dtypes of the tree's leaves, in tree order."""
    return ";".join(
        f"{'/'.join(map(str, path))}:{tuple(leaf.shape)}:{leaf.dtype}"
        for path, leaf in tree_util.flatten(tree))


def _host(leaf) -> torch.Tensor:
    """A leaf's global tensor on the CPU."""
    if isinstance(leaf, spmd.ShardedTensor):
        return spmd.gather(leaf, "cpu")
    return leaf.detach().cpu()


def save_checkpoint(path: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` to ``<path>/step_<step>.ckpt``."""
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(step), "fingerprint": fingerprint(tree),
               "leaves": [_host(leaf) for leaf in tree_util.leaves(tree)]}
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


def _place(saved: torch.Tensor, like, sharding):
    if sharding is None and isinstance(like, spmd.ShardedTensor):
        sharding = like.sharding
    if sharding is not None:
        return spmd.device_put(saved, sharding)
    return saved.to(like.device)


def restore_checkpoint(file: str, like: Any, shardings: Any = None):
    """``(step, tree)``: the snapshot in ``like``'s structure.  With
    ``shardings`` (a tree of ``NamedSharding``s of ``like``'s structure),
    each leaf is laid out by its sharding -- on any mesh shape, whatever
    the mesh the file was written from; without, as ``like``'s leaf is: a
    ShardedTensor by its sharding, a tensor on its device.  Raises
    ``ValueError`` when the saved tree's key paths, shapes or dtypes
    differ from ``like``'s, or ``shardings`` has another number of
    leaves."""
    payload = torch.load(file, map_location="cpu", weights_only=True,
                         mmap=True)
    if payload["fingerprint"] != fingerprint(like):
        raise ValueError(
            "checkpoint tree mismatch -- incompatible model/opt config")
    cur = tree_util.leaves(like)
    if shardings is None:
        shards = [None] * len(cur)
    else:
        shards = tree_util.leaves(shardings)
        if len(shards) != len(cur):
            raise ValueError(f"shardings has {len(shards)} leaves, the "
                             f"tree {len(cur)}")
    leaves = [_place(saved, c, s) for saved, c, s in
              zip(payload["leaves"], cur, shards)]
    return payload["step"], tree_util.unflatten(like, leaves)


def prune_checkpoints(path: str, keep: int) -> None:
    if not os.path.isdir(path):
        return
    files = sorted(f for f in os.listdir(path) if _NAME.fullmatch(f))
    for f in files[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(path, f))
