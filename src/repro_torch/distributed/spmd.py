"""Sharded execution on a single-controller mesh: the port's counterpart of
``jax.jit(step, in_shardings=..., out_shardings=...)`` for the language
models' training step.

The reference lays parameters, optimizer state and batch out by the rules
of :mod:`repro_torch.distributed.sharding` and lets GSPMD partition the
program.  The port has no partitioner, so this module executes the
shardings itself, on a :class:`~repro_torch.distributed.sharding.Mesh`
that may repeat a device (``["cuda:0"] * 8`` stands in for eight cards).

**Containers.**  A :class:`ShardedTensor` holds one local tensor per mesh
position, laid out by a :class:`~.sharding.NamedSharding`; positions on
axes its spec does not name hold replicas (separate tensors, even on one
device).  :func:`device_put` lays a tree out, :func:`gather` assembles a
global tensor.

**Collectives** (:func:`all_gather`, :func:`all_reduce`,
:func:`reduce_scatter`, :func:`replicate`, :func:`split`, a
:class:`PartialSum` reduced by :func:`device_put`, :func:`microbatches`,
:func:`cast_into`, :func:`seq_gather`) are built from
``Tensor.to``, ``cat``, slices and sums, so autograd differentiates them.
Each goes through :func:`record`, which appends ``(kind, bytes, group
size)`` to the :class:`CollectiveLog` being recorded, with the kinds of
the reference's HLO parser (``launch/hlo_parse.py:30``) and ``bytes`` the
collective's output per device as that parser counts it.  The log is ONE
device's schedule (the mesh's first), as one SPMD program's collective
instructions are: a collective that every data group or every model
shard performs at once is logged once.  On a mesh that repeats a device
the copies cost nothing; the log still counts what a mesh of cards
needs.  A forward collective inside a rematerialised layer is logged
again when the layer is recomputed.

**The design.**

* *Data.*  The batch is split over the data axes by its sharding (the
  fallback of ``choose_pspec`` included: groups that hold the same rows
  run once, the first of them).  Each data group (the positions that
  share one index on the data axes) runs the program on its first
  device, its *home*, where its activations live; a weight replicated
  over the model axis is read from the home's replica.  The groups run in
  lockstep, layer by layer, because a MoE layer routes the tokens of all
  groups together: its capacity and the rank of each assignment within
  its expert are those of the whole batch, as under GSPMD (an
  ``all-gather`` of the groups' per-expert counts gives each group its
  offset; each group then dispatches and combines its own tokens).  The
  loss sums each group's terms (negative log-likelihood, token count and,
  for MoE models, the first layer's router statistics) in one
  ``all-reduce`` over the data axes and forms the global loss from them;
  one backward pass then runs through every group's graph.
* *Weights in matmuls* go through :func:`einsum`.  On a model-sharded
  weight: where the sharded dimension is free in the product (``ff``,
  ``heads``, ``head`` of a projection, ``ssm_inner``, ``vocab``), each
  shard computes its slice on its own device and the result is
  all-gathered (backward: an all-reduce of the input's gradient); where it
  is contracted, each shard takes its slice of the input and the partial
  products are all-reduced (backward: an all-gather of the input's
  gradient).  :func:`embedding` is the same product with one-hot tokens:
  a vocab-sharded table looks up the tokens in its range and all-reduces.
* *Regions* (:func:`shard_map`): a block whose weights are all sharded on
  one logical axis runs per shard and meets the others once.  The MLP
  (``ff`` on ``wu``/``wg``/``wd``) all-reduces its output (Megatron); MoE
  experts: with ``experts`` sharded, each shard runs its E/m experts of
  the dispatch buffer and the outputs are all-gathered (expert
  parallelism); with ``ff`` sharded, as the MLP.  Attention is head-local
  where ``wq`` is sharded on ``heads`` and ``wk``/``wv`` on ``kv_heads``
  (granite at model 4: 6 of 24 and 2 of 8 heads a shard): each shard
  projects, runs the attention kernel at H/m and Hkv/m heads, and takes
  its part of ``wo``; the partial outputs are all-reduced.
* *Gather fallback* (:func:`local`): a model-sharded weight that is not
  used in a matmul (norms, ``A_log``, ``D_skip``, ``dt_bias``, the conv
  weights on ``ssm_x``, hymba's fused ``w_in``, whose column split does
  not follow the z/x/B/C/dt boundaries) is all-gathered on its first use,
  once per step and data group (:func:`step_scope` keeps it across
  microbatches and recomputations), on the group's home.
* *Gradients.*  A shard's gradient lands on its device.  They are reduced
  over the data groups into the optimizer state's layout (``zero1`` of
  ``opt_state_axes``: a ``reduce-scatter``, an ``all-reduce`` where no
  dimension divides), once per microbatch (a ZeRO-2 layout: the
  reference constrains them to the zero1 layout of the ambient data axes,
  the same layout wherever those are the optimizer state's); AdamW runs
  per optimizer-state shard on its device, after one ``all-reduce`` of
  the squared gradient norm; the updated master slices, cast to the
  compute dtype, are
  all-gathered back into the parameter layout.  With several microbatches
  the batch is first re-cut so that microbatch i holds the global rows
  the single-device step gives it (an ``all-to-all`` per batch leaf).
* *dp-only* (``parallel_policy="dp_only"``: the data axes hold the model
  axis too, :class:`Layout`'s ``overlap``).  Each data group is one
  position, its own home, and reads every replicated weight from its own
  replica.  A weight still split over the model axis (the vocab-split
  table and LM head) lies on the group's *line*, the positions that
  differ from it only on the model axis: every use gathers it
  (:func:`local`, once a step and group; the tied head is the gathered
  table's transpose), and each group differentiates its own leaves of
  the line's shards (``ShardedTensor.reads``), so that its gradient of
  the whole table is one term of the reduction over every group.  The
  caches follow the batch (``launch/steps.py::cache_layout``).
* *Sequence parallelism* (``cfg.seq_parallel``, training only, as in the
  reference): where ``choose_pspec`` puts ``seq_sp`` on the model axis,
  each data group's residual stream enters the layers split by sequence
  over its model shards (a :class:`SeqSplit`; :func:`seq_split`, whose
  backward all-gathers) and leaves them gathered.  Norms and residual
  adds run per block (:func:`rowwise`; a norm's weight gradient is
  all-reduced over the shards); a block's input is all-gathered over the
  sequence (:func:`seq_gather`) and its row-parallel outputs
  (:func:`shard_map`'s ``"sum"`` under :func:`seq_scope`: attention's
  ``wo``, the SSM's ``w_out``, the MLP's ``wd``) are reduce-scattered
  over the sequence instead of all-reduced.  Backward swaps them: the
  outputs' gradients are all-gathered and the inputs' reduce-scattered
  (in place of the all-reduce :func:`replicate` logs for a region's
  input).  The MoE layer routes the gathered tokens and its combined
  output is split back (backward: an all-gather).
* *No mesh.*  On plain tensors every primitive calls the code it wraps,
  unchanged, so the single-device path runs the same operations as
  before.

**Where the reference's activation constraints go.**  The reference pins
layouts with ``logical_constraint``; the port calls no such pin, and the
executor decides each layout where the reference pinned it:

* ``attention.py:164-179`` (q ``heads``, k/v ``kv_heads``, the output
  replicated): head-local attention keeps q/k/v per shard and all-reduces
  the output; otherwise the projections' outputs are all-gathered and
  attention runs on the home at full heads.
* ``ssm.py:172`` (the fused projection on ``ssm_x``): ``w_in`` is
  gathered, the projection runs on the home; ``ssm.py:216`` (the output
  replicated): ``w_out``'s partial products are all-reduced.
* ``moe.py:72-90`` (the dispatch buffer on experts x batch): the buffer
  is per data group (its own tokens) and split over the model shards by
  expert; the outputs are all-gathered.
* ``transformer.py:106-195, 374`` (the MLP's hidden on ``ff``, the
  residual stream and logits): the MLP's hidden stays per shard; the
  residual stream is replicated over the model axis on each group's home,
  or split by sequence between the layers under ``seq_parallel``
  (``transformer.py:136-139``); the logits are all-gathered over
  ``vocab`` (under dp-only, the batch holds the model axis: the table is
  gathered instead).

**Prefill and decode** (``transformer.prefill``/``decode_step`` on
sharded params, as the reference's ``jax.jit`` partitions them over
sharded inputs) run the data groups in lockstep as the train step does,
and lay the caches out by ``launch/steps.py::cache_layout``
(``cache_pspecs``, but under dp-only the batch's spec and nothing on the
model axis): the layers
axis whole, the batch over the data axes (with its fallback: long_500k's
one row is held by every group and run by the first), kv heads, ``hd``,
SSM heads or conv channels over the model axis.  Each cache piece is
written on its own device, into every position that holds its rows:

* *keys and values*: where ``wq``/``wk``/``wv`` are head-local, each shard
  writes its own kv heads; otherwise the projections are all-gathered,
  rope'd at full ``hd`` on the home (rope rotates the two halves of
  ``hd`` together, so an ``hd`` split cannot rope its slice alone) and only
  then split into the cache's shards.  Decode on kv split over heads:
  each shard scores its heads against its shard; on kv split over
  ``hd``: each shard's scores are a partial sum over its ``hd`` slice,
  reduced with one all-reduce before the softmax, and each shard's output
  is its ``hd`` slice.  The shards' partial ``wo`` products are
  all-reduced where ``wo`` splits the same way, else the outputs are
  all-gathered first.
* *the SSM*: the conv tail split over channels (hymba's 3232 / 2 cuts
  ``x`` and leaves B and C on the last shard): each shard convolves its
  channels and the activations are all-gathered; the state split over
  heads (or the head dimension): prefill writes each state shard from
  its heads' inputs and the B columns of their groups, decode updates
  each shard with its heads and their B and C columns, the outputs
  all-gathered.
* *logits*: the last position's, all-gathered over ``vocab``, returned as
  a ShardedTensor split over the batch.

**Meshes of ``meta`` devices** (``repro_torch.launch.dryrun``) run the
same programs on shapes alone: the counterpart of the reference's
``jit(...).lower().compile()`` on 512 forced host devices, giving the
collective log, one device's FLOPs and its shard sizes without storage.
There, re-layouts make each slice at its shape, and (:func:`per_group`,
:func:`shard_map`) the first data group's and model shard's results
stand for the others', whose shapes are the same.

Refused: mesh axes other than the data axes and the model axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree

from . import sharding
from .sharding import Mesh, NamedSharding, device_scope


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------


class ShardedTensor:
    """A global tensor of ``shape`` laid out by ``sharding``: ``shards`` is
    an object array of ``mesh.devices``' shape holding each position's
    local tensor on that position's device.  ``reads`` (set by
    :func:`grad_leaves` where the data groups overlap the model axis):
    ``{group index: [tensor per model index]}``, the shards each group
    reads in place of ``shards``' (its own leaves, for its own
    gradient)."""

    def __init__(self, shards: np.ndarray, sharding: NamedSharding,
                 shape: tuple, reads: Optional[dict] = None):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.reads = reads

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def index(self, position: tuple) -> tuple:
        """The global slices the shard at ``position`` holds."""
        return self.sharding.index(position, self.shape)

    def pieces(self, prefer: Optional[tuple] = None,
               want: Optional[tuple] = None) -> list:
        """``[(global slices, tensor)]``, one per distinct slice (only
        those that meet the global slices ``want``, when given), each the
        shard of the holder nearest ``prefer``: the position that shares
        ``prefer``'s coordinate on every axis the spec does not name.
        Without ``prefer``, each slice's first holder, in mesh order."""
        sh = self.sharding
        local = sh.shard_shape(self.shape)
        parts = sh.parts(self.ndim)
        if want is None:
            ranges = [range(k) for k in parts]
        else:
            ranges = [range(w.start // n, -(-w.stop // n)) if n else
                      range(0) for w, n in zip(want, local)]
        near = prefer or (0,) * self.shards.ndim
        out = []
        for blocks in itertools.product(*ranges):
            pos = sh.holder(blocks, near)
            out.append((pos, tuple(slice(b * n, (b + 1) * n)
                                   for b, n in zip(blocks, local))))
        if prefer is None:
            out.sort(key=lambda ps: ps[0])
        return [(sl, self.shards[pos]) for pos, sl in out]

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"spec={self.sharding.spec}, mesh={self.mesh.shape})")


def is_sharded(t) -> bool:
    """Whether a tree holds :class:`ShardedTensor` leaves."""
    return any(isinstance(x, ShardedTensor) for x in tree.leaves(t))


def _positions(mesh: Mesh) -> list:
    return list(np.ndindex(mesh.devices.shape))


def assemble(pieces: Sequence, want: tuple, device,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The block ``want`` (global slices) of a tensor held as ``pieces``
    (``[(global slices, tensor)]``), a new tensor on ``device``.  On
    ``meta`` (shapes only: nothing to copy) the block is made at its
    shape."""
    shape = [w.stop - w.start for w in want]
    if torch.device(device).type == "meta":
        if not pieces:
            raise ValueError(f"no piece covers {want}")
        return torch.empty(shape, dtype=dtype or pieces[0][1].dtype,
                           device=device)
    out = None
    for sl, t in pieces:
        inter = [(max(a.start, w.start), min(a.stop, w.stop))
                 for a, w in zip(sl, want)]
        if any(lo >= hi for lo, hi in inter):
            continue
        src = t[tuple(slice(lo - a.start, hi - a.start)
                      for (lo, hi), a in zip(inter, sl))]
        if [hi - lo for lo, hi in inter] == shape:    # one copy, no more
            return src.to(device=device, dtype=dtype or t.dtype, copy=True,
                          memory_format=torch.contiguous_format)
        if out is None:
            out = torch.empty(shape, dtype=dtype or t.dtype, device=device)
        out[tuple(slice(lo - w.start, hi - w.start)
                  for (lo, hi), w in zip(inter, want))].copy_(src)
    if out is None:
        raise ValueError(f"no piece covers {want}")
    return out


class PartialSum:
    """A global tensor of ``shape`` that is the sum of one term per data
    group, each held as pieces ``[(global slices, tensor)]`` (the
    gradients of the groups' replicas of one weight).  :func:`device_put`
    reduces it into a layout: a reduce-scatter where the layout splits it
    over the data axes, an all-reduce where it does not."""

    def __init__(self, terms: list, shape):
        self.terms, self.shape = terms, torch.Size(shape)


def _wanted(sh: NamedSharding, shape) -> dict:
    """``{global slices: [positions]}``: the positions of ``sh``'s mesh
    that hold each distinct slice of a tensor of ``shape``, in mesh
    order."""
    out = {}
    for p in _positions(sh.mesh):
        out.setdefault(sh.index(p, shape), []).append(p)
    return out


def _copies(value: torch.Tensor, positions: list, mesh: Mesh,
            shards: np.ndarray) -> None:
    """``value`` (the shard of ``positions[0]``) and one copy of it on the
    device of each other position, into ``shards``."""
    shards[positions[0]] = value
    for p in positions[1:]:
        shards[p] = value.to(mesh.devices[p], copy=True)


def _put(x, sh: NamedSharding) -> ShardedTensor:
    shards = np.empty(sh.mesh.devices.shape, dtype=object)
    for want, positions in _wanted(sh, x.shape).items():
        dev = sh.mesh.devices[positions[0]]
        if isinstance(x, PartialSum):     # summed in float32, in order
            value = (assemble(x.terms[0], want, dev, torch.float32)
                     if dev.type == "meta" else
                     sum(assemble(t, want, dev, torch.float32)
                         for t in x.terms))
        elif isinstance(x, ShardedTensor):
            value = assemble(x.pieces(prefer=positions[0], want=want), want,
                             dev)
        else:
            value = x[want].to(dev, copy=True,
                               memory_format=torch.contiguous_format)
        _copies(value, positions, sh.mesh, shards)
    if isinstance(x, PartialSum):
        data = Layout(sh.mesh).data_axes
        split_ = any(set(sharding._entry_axes(e)) & set(data)
                     for e in sh.spec)
        piece = x.terms[0][0][1]
        record("reduce-scatter" if split_ else "all-reduce",
               _nbytes(sh.shard_shape(x.shape), piece.dtype), len(x.terms))
    return ShardedTensor(shards, sh, x.shape)


def device_put(t, shardings):
    """Lay ``t`` (a tensor, a :class:`ShardedTensor` to re-lay, a
    :class:`PartialSum` to reduce, or a tree of them) out by ``shardings``
    (a :class:`NamedSharding`, or a tree of them of ``t``'s
    structure)."""
    if isinstance(shardings, NamedSharding):
        return _put(t, shardings)
    return tree.tree_map(_put, t, shardings)


def gather(x: ShardedTensor, device) -> torch.Tensor:
    """The global tensor of ``x`` on ``device``: one copy of each distinct
    slice, from its first holder in mesh order, into one tensor there (to
    ``"cpu"``: no device holds more than its own shards)."""
    return assemble(x.pieces(), tuple(slice(0, n) for n in x.shape), device)


def zeros(shape, dtype: torch.dtype, sh: NamedSharding) -> ShardedTensor:
    """A zero tensor of global ``shape`` laid out by ``sh``: one fresh
    local tensor per position."""
    shards = np.empty(sh.mesh.devices.shape, dtype=object)
    local = sh.shard_shape(shape)
    for p in _positions(sh.mesh):
        shards[p] = torch.zeros(local, dtype=dtype, device=sh.mesh.devices[p])
    return ShardedTensor(shards, sh, shape)


def holders(x: ShardedTensor, rows: slice, dim: int = 1) -> list:
    """``[(position, model index)]``: the positions whose shard of ``x``
    holds exactly the global ``rows`` of dimension ``dim``, in mesh order
    (the model index is the position's coordinate on the model axis, 0
    without one)."""
    key = ("holders", dim, tuple(x.shape))
    table = x.sharding._memo.get(key)
    if table is None:
        names = x.mesh.axis_names
        model = Layout(x.mesh).model_axis
        k = names.index(model) if model in names else None
        table = {}
        for p in _positions(x.mesh):
            sl = x.index(p)[dim]
            table.setdefault((sl.start, sl.stop), []).append(
                (p, 0 if k is None else p[k]))
        x.sharding._memo[key] = table
    got = table.get((rows.start, rows.stop))
    if got is None:
        raise ValueError(f"{x}: no shard holds rows {rows.start}:{rows.stop} "
                         f"of dimension {dim}")
    return got


def write_rows(x: ShardedTensor, layer: int, rows: slice, value=None,
               parts=None) -> None:
    """Write layer ``layer``'s block of batch ``rows`` into every shard of
    ``x`` (a tensor stacked over layers: (layers, batch, ...)) that holds
    those rows, on its own device, at the leading slots of each
    dimension: ``value`` at full width (each shard takes its slice of the
    dimension ``x`` splits over the model axis), or ``parts``, one tensor
    per model index, already sliced."""
    k = Layout(x.mesh).cache_dim(x)
    for p, j in holders(x, rows):
        if parts is not None:
            part = parts[j]
        elif k is None:
            part = value
        else:
            n = value.shape[k - 1] // x.sharding.parts(x.ndim)[k]
            part = value.narrow(k - 1, j * n, n)
        dst = x.shards[p][layer]
        dst[tuple(slice(0, size) for size in part.shape)].copy_(part)


def from_rows(values: dict, sh: NamedSharding, shape) -> ShardedTensor:
    """A tensor of global ``shape`` laid out by ``sh``, which splits no
    dimension but the first, from ``values`` (``{(start, stop): the
    tensor of those rows}``, one per distinct slice): the first position
    that holds a slice takes its tensor (moved to its device), the others
    a copy."""
    shards = np.empty(sh.mesh.devices.shape, dtype=object)
    for want, positions in _wanted(sh, shape).items():
        v = values[(want[0].start, want[0].stop)]
        _copies(v.to(sh.mesh.devices[positions[0]]), positions, sh.mesh,
                shards)
    return ShardedTensor(shards, sh, shape)


# ---------------------------------------------------------------------------
# the collective log
# ---------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


class Collective(NamedTuple):
    kind: str
    bytes: int          # the collective's output per device
    group: int          # devices in its group


class CollectiveLog(list):
    """The collectives of one step as one device performs them."""

    def by_kind(self) -> dict:
        """``{kind: (count, bytes)}``."""
        out = {}
        for c in self:
            n, b = out.get(c.kind, (0, 0))
            out[c.kind] = (n + 1, b + c.bytes)
        return out


class _State(threading.local):
    def __init__(self):
        self.log: Optional[CollectiveLog] = None
        self.logging = True       # this program's device is the logged one
        self.memo: Optional[dict] = None
        self.seq: Optional[list] = None   # devices of a seq_scope


_STATE = _State()


@contextlib.contextmanager
def recording(log: CollectiveLog):
    """Record the collectives run inside into ``log``."""
    prev = _STATE.log, _STATE.logging
    _STATE.log, _STATE.logging = log, True
    try:
        yield log
    finally:
        _STATE.log, _STATE.logging = prev


@contextlib.contextmanager
def step_scope():
    """Keep the gathered fallback weights (:func:`local`) from their first
    use to the end of the scope; nested scopes share the outer one."""
    if _STATE.memo is not None:
        yield
        return
    _STATE.memo = {}
    try:
        yield
    finally:
        _STATE.memo = None


def recompute_context():
    """``torch.utils.checkpoint``'s ``context_fn``: on a card a checkpointed
    region is recomputed in autograd's worker thread, whose thread-local
    state is empty; the second context re-installs there the log, the
    logging flag and the gather memo of the region's first run."""
    state = (_STATE.log, _STATE.logging, _STATE.memo)

    @contextlib.contextmanager
    def restored():
        prev = (_STATE.log, _STATE.logging, _STATE.memo)
        _STATE.log, _STATE.logging, _STATE.memo = state
        try:
            yield
        finally:
            _STATE.log, _STATE.logging, _STATE.memo = prev

    return contextlib.nullcontext(), restored()


def _target():
    return _STATE.log if _STATE.logging else None


def record(kind: str, nbytes: int, group: int, log=None) -> None:
    """Append one collective to the log being recorded (``log``: a target
    captured earlier, for a backward pass), if this is the logged device's
    program and the group holds more than one device."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    log = _target() if log is None else log
    if log is not None and group > 1:
        log.append(Collective(kind, int(nbytes), int(group)))


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= s
    return n * (torch.finfo(dtype).bits if dtype.is_floating_point
                else torch.iinfo(dtype).bits) // 8


class _Mark(torch.autograd.Function):
    """Identity that records a collective when its forward runs
    (``fwd``) and when its backward runs (``bwd``, of ``scale`` times the
    gradient's bytes)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, group, scale=1):
        ctx.bwd, ctx.group, ctx.log, ctx.scale = bwd, group, _target(), scale
        if fwd is not None:
            record(fwd, _nbytes(x.shape, x.dtype), group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd is not None and ctx.log is not None:
            record(ctx.bwd, _nbytes(g.shape, g.dtype) * ctx.scale,
                   ctx.group, ctx.log)
        return g, None, None, None, None


def _mark(x, fwd, bwd, group, scale=1):
    if not x.requires_grad:
        bwd = None
        if fwd is None:
            return x
    return _Mark.apply(x, fwd, bwd, group, scale)


def replicate(x, devices) -> list:
    """``x`` (replicated: every device of the group holds it) handed to
    each of ``devices``; backward: the shards' gradients all-reduced (for
    an input gathered by :func:`seq_gather`, its backward's
    reduce-scatter takes the place of the all-reduce)."""
    flag = getattr(x, "_seq_partial", None)
    if flag is not None:
        flag[0] = True
    else:
        x = _mark(x, None, "all-reduce", len(devices))
    return [x.to(d) for d in devices]


def split(x, dim: int, devices) -> list:
    """Slice ``j`` of ``x`` along ``dim`` to ``devices[j]``; backward: the
    slices' gradients all-gathered."""
    x = _mark(x, None, "all-gather", len(devices))
    n = x.shape[dim] // len(devices)
    return [x.narrow(dim, j * n, n).to(d) for j, d in enumerate(devices)]


def all_gather(parts: Sequence, dim: int, home) -> torch.Tensor:
    """The parts joined along ``dim`` on ``home``."""
    out = torch.cat([p.to(home) for p in parts], dim=dim)
    return _mark(out, "all-gather", None, len(parts))


def all_reduce(parts: Sequence, home) -> torch.Tensor:
    """The parts' sum on ``home``, in order."""
    out = parts[0].to(home)
    for p in parts[1:]:
        out = out + p.to(home)
    return _mark(out, "all-reduce", None, len(parts))


def reduce_scatter(parts: Sequence, dim: int, devices) -> list:
    """The parts' sum cut along ``dim``: block ``j`` summed (in order) on
    ``devices[j]``; backward: the blocks' gradients all-gathered."""
    m = len(devices)
    n = parts[0].shape[dim] // m
    out = []
    for j, d in enumerate(devices):
        s = parts[0].narrow(dim, j * n, n).to(d)
        for p in parts[1:]:
            s = s + p.narrow(dim, j * n, n).to(d)
        out.append(s)
    out[0] = _mark(out[0], "reduce-scatter", "all-gather", m, m)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: the residual stream split by sequence
# ---------------------------------------------------------------------------


class SeqSplit:
    """A data group's activations (B, L, ...) split by sequence over its
    model shards: ``parts[j]`` on ``devices[j]`` holds positions
    ``[j L/m, (j+1) L/m)``."""

    def __init__(self, parts: list, devices: list):
        self.parts, self.devices = parts, devices


class _Partial(torch.autograd.Function):
    """Identity on an input gathered by :func:`seq_gather`; its backward
    records the reduce-scatter of the gradient over the sequence when a
    model-sharded region read the input (``flag[0]``, set by
    :func:`replicate`): the shards' gradients are then partial sums."""

    @staticmethod
    def forward(ctx, x, flag, group):
        ctx.flag, ctx.group, ctx.log = flag, group, _target()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.flag[0] and ctx.log is not None:
            record("reduce-scatter", _nbytes(g.shape, g.dtype) // ctx.group,
                   ctx.group, ctx.log)
        return g, None, None


def seq_split(x, devices) -> SeqSplit:
    """``x`` (whole on the home, as every model shard holds it) cut by
    sequence, each shard keeping its block: no collective; backward: the
    blocks' gradients all-gathered."""
    return SeqSplit(split(x, 1, devices), devices)


def seq_gather(x):
    """A :class:`SeqSplit` whole on its first device, the group's home (an
    all-gather; backward: a reduce-scatter where a model-sharded region
    reads it, else each shard takes its block of the gradient); any other
    value as it is."""
    if not isinstance(x, SeqSplit):
        return x
    out = all_gather(x.parts, 1, x.devices[0])
    if out.requires_grad:
        flag = [False]
        out = _Partial.apply(out, flag, len(x.parts))
        out._seq_partial = flag
    return out


@contextlib.contextmanager
def seq_scope(x):
    """Where ``x`` (a block's input) is a :class:`SeqSplit`, the block's
    row-parallel outputs (:func:`shard_map` with ``out="sum"``) are
    reduce-scattered over the sequence into a SeqSplit instead of
    all-reduced."""
    if not isinstance(x, SeqSplit):
        yield
        return
    prev = _STATE.seq
    _STATE.seq = x.devices
    try:
        yield
    finally:
        _STATE.seq = prev


def rowwise(fn: Callable, args: tuple, weights: tuple = ()):
    """``fn(*args, *weights)``, position by position: where an argument is
    a :class:`SeqSplit`, per block on its device, with every SeqSplit
    argument's block, every tensor argument's block (:func:`split`) and
    the weights replicated (:func:`replicate`: their gradients
    all-reduced); a SeqSplit back.  Otherwise ``fn`` runs once on what it
    is given."""
    seq = next((a for a in args if isinstance(a, SeqSplit)), None)
    if seq is None:
        return fn(*args, *weights)
    devices = seq.devices
    per_arg = [a.parts if isinstance(a, SeqSplit) else split(a, 1, devices)
               for a in args]
    per_w = [replicate(local(w), devices) for w in weights]
    outs = []
    for j, dev in enumerate(devices):
        if j and dev.type == "meta":
            outs.append(outs[0])
            continue
        with on_shard(j, dev):
            outs.append(fn(*(a[j] for a in per_arg), *(w[j] for w in per_w)))
    return SeqSplit(outs, devices)


# ---------------------------------------------------------------------------
# the execution layout: data groups and model shards
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Group:
    """One data group: its index on the data axes, its positions along
    the model axis and their devices (the first is its home)."""
    index: int
    positions: list
    devices: list
    first: bool = False

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @contextlib.contextmanager
    def active(self):
        """Run this group's program: its home current, the collectives
        logged only for the first group."""
        prev = _STATE.logging
        _STATE.logging = prev and self.first
        try:
            with device_scope(self.home):
                yield
        finally:
            _STATE.logging = prev


@contextlib.contextmanager
def on_shard(j: int, device):
    """Run model shard ``j``'s part of a region on ``device`` (current
    there); only shard 0's part is the logged device's program."""
    prev = _STATE.logging
    _STATE.logging = prev and j == 0
    try:
        with device_scope(device):
            yield
    finally:
        _STATE.logging = prev


def logged() -> bool:
    """Whether the program running now is the logged device's (the first
    data group's home, model shard 0): what a per-device count reads."""
    return _STATE.logging


def per_group(groups: List["Group"], fn: Callable, *args) -> list:
    """``[fn(g, *a) for g, *a in zip(groups, *args)]``, each call under
    ``g.active()``.  On ``meta`` devices (the dry-run: shapes only) the
    first group's result stands for every group's: the runners hold equal
    slices of the batch, so their programs have the same shapes, and only
    the first is logged."""
    out = []
    for i, (g, *a) in enumerate(zip(groups, *args)):
        if i and g.home.type == "meta":
            out.append(_stand_in(out[0]))
            continue
        with g.active():
            out.append(fn(g, *a))
    return out


class _StandIn(torch.autograd.Function):
    """Identity that saves its input for backward: on a run whose groups
    are elided, a checkpoint's recomputation (which stops once every saved
    tensor is back) still recomputes all of the first group's part, as it
    does when the other groups' parts follow it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _stand_in(x):
    if isinstance(x, SeqSplit):
        return SeqSplit([_stand_in(p) for p in x.parts], x.devices)
    if isinstance(x, torch.Tensor) and x.requires_grad:
        return _StandIn.apply(x)
    return x


class Layout:
    """The data axes and the model axis of ``mesh``, from the ambient
    :func:`~.sharding.mesh_context` when it holds ``mesh`` (else the
    defaults: ``pod``/``data`` and ``model``).  The model axis may also be
    a data axis (the dp-only policy, ``overlap``): each data group is then
    one position, and a weight split over the model axis lies on the
    positions of its *line* (those that differ from the group's only on
    the model axis), in other groups."""

    def __init__(self, mesh: Mesh):
        ctx = sharding._CTX
        names = mesh.axis_names
        if ctx.mesh is mesh:
            self.data_axes, self.model_axis = ctx.data_axes, ctx.model_axis
        else:
            self.data_axes = tuple(a for a in ("pod", "data") if a in names)
            self.model_axis = "model" if "model" in names else None
        other = set(names) - set(self.data_axes) - {self.model_axis}
        if other:
            raise ValueError(f"sharded execution runs on data and model axes "
                             f"only; the mesh also has {sorted(other)}")
        self.mesh = mesh
        self.m = mesh.shape[self.model_axis] if self.model_axis else 1
        self.overlap = self.model_axis in self.data_axes

    @classmethod
    def of(cls, t) -> "Layout":
        leaf = next(x for x in tree.leaves(t) if isinstance(x, ShardedTensor))
        return cls(leaf.mesh)

    def groups(self) -> List[Group]:
        names = self.mesh.axis_names
        out = []
        for k, idx in enumerate(itertools.product(
                *(range(self.mesh.shape[a]) for a in self.data_axes))):
            at = dict(zip(self.data_axes, idx))
            pos = ([tuple(at[a] for a in names)] if self.overlap else
                   [tuple(j if a == self.model_axis else at[a] for a in names)
                    for j in range(self.m)])
            out.append(Group(k, pos, [self.mesh.devices[p] for p in pos]))
        return out

    def line(self, position: tuple) -> list:
        """The positions along the model axis through ``position``."""
        k = self.mesh.axis_names.index(self.model_axis)
        return [position[:k] + (j,) + position[k + 1:] for j in range(self.m)]

    def model_dim(self, x: ShardedTensor) -> Optional[int]:
        """The dimension the weight ``x`` splits over the model axis
        (``None``: it is replicated over it, or the axis has one device).
        Where the groups overlap the model axis, a dimension split over it
        with other data axes is a data split, not a model one."""
        if self.m == 1:
            return None
        for i, e in enumerate(x.sharding.spec):
            if self.model_axis in sharding._entry_axes(e):
                if self.overlap and e != self.model_axis:
                    continue
                if e != self.model_axis:
                    raise ValueError(f"{x}: the model axis shares a "
                                     f"dimension with other axes")
                return i
        return None

    def cache_dim(self, x: ShardedTensor) -> Optional[int]:
        """The dimension a cache ``x`` splits over the model axis; none
        where the groups overlap it (the caches then follow the batch,
        ``launch/steps.py::cache_layout``)."""
        return None if self.overlap else self.model_dim(x)

    def runners(self, batch) -> List[Group]:
        """The groups that run the program: one per distinct slice of the
        batch (its leaves are split on dim 0 over some data axes), in the
        order of their rows; the first logs."""
        leaves = [x for x in tree.leaves(batch)]
        if not all(isinstance(x, ShardedTensor) and x.mesh is self.mesh
                   for x in leaves):
            raise ValueError("a sharded step takes a batch of ShardedTensors "
                             "on the parameters' mesh")
        specs = {tuple(x.sharding.spec) + (None,) * (x.ndim - len(
            x.sharding.spec)) for x in leaves}
        entry = leaves[0].sharding.spec[0] if leaves[0].sharding.spec \
            else None
        if any(s[0] != entry or any(s[1:]) for s in specs) or not set(
                sharding._entry_axes(entry)) <= set(self.data_axes):
            raise ValueError(f"the batch must split its leading dimension "
                             f"over data axes only, got {specs}")
        axes = sharding._entry_axes(entry)
        names = self.mesh.axis_names
        out = [g for g in self.groups()
               if all(g.positions[0][names.index(a)] == 0
                      for a in self.data_axes if a not in axes)]
        out.sort(key=lambda g: leaves[0].index(g.positions[0])[0].start)
        out[0].first = True
        return out


# ---------------------------------------------------------------------------
# a data group's view of the weights, and the primitives the model calls
# ---------------------------------------------------------------------------


class Shards:
    """A data group's model shards of one weight: ``parts[j]`` on
    ``devices[j]`` is block ``j`` of dimension ``dim``.  ``key`` names it
    for the gather memo of :func:`local`.  ``home``: the group's home
    (``devices[0]`` unless the groups overlap the model axis: then the
    shards lie in other groups, and every use gathers the weight, ``gather``;
    ``base``: the parent and the step that made a child)."""

    def __init__(self, parts: list, devices: list, dim: int, key: tuple,
                 home=None, gather: bool = False, base=None):
        self.parts, self.devices, self.dim, self.key = parts, devices, dim, key
        self.home = devices[0] if home is None else home
        self.gather, self.base = gather, base

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.dim] *= len(self.parts)
        return torch.Size(s)

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    def _child(self, parts, dim, step) -> "Shards":
        return Shards(parts, self.devices, dim, self.key + (step,),
                      self.home, self.gather, (self, step))

    def __getitem__(self, i: int) -> "Shards":
        if not isinstance(i, int) or self.dim == 0:
            raise TypeError("a sharded weight takes one integer index, "
                            "on an unsharded leading dimension")
        return self._child([p[i] for p in self.parts], self.dim - 1, i)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a sharded weight unbinds its leading dimension")
        return [self[i] for i in range(self.shape[0])]

    @property
    def T(self) -> "Shards":
        if self.ndim != 2:
            raise ValueError("T takes a 2-D sharded weight")
        return self._child([p.T for p in self.parts], 1 - self.dim, "T")


def views(t, group: Group, layout: Layout, data: bool = False):
    """``t``'s leaves as ``group`` reads them: a :class:`Shards` for a
    leaf split over the model axis, else the tensor at the group's home
    position (always, for ``data``: a batch, split over data axes
    only)."""
    def leaf(x):
        if not isinstance(x, ShardedTensor):
            return x
        k = None if data else layout.model_dim(x)
        if k is None:
            return x.shards[group.positions[0]]
        if layout.overlap:
            line = layout.line(group.positions[0])
            parts = (x.reads[group.index] if x.reads is not None else
                     [x.shards[p] for p in line])
            return Shards(parts, [layout.mesh.devices[p] for p in line], k,
                          (id(x), group.index), group.home, gather=True)
        return Shards([x.shards[p] for p in group.positions], group.devices,
                      k, (id(x), group.index))

    return tree.tree_map(leaf, t)


def local(w):
    """A weight used outside a matmul (or, where the groups overlap the
    model axis, anywhere), whole on the group's home: a :class:`Shards` is
    all-gathered at its first use in the :func:`step_scope` (the gather
    fallback; a child of a gathering weight is the same step on its
    parent's gather); a tensor is returned as it is."""
    if not isinstance(w, Shards):
        return w
    if w.gather and w.base is not None:
        parent, step = w.base
        full = local(parent)
        return full.T if step == "T" else full[step]
    memo = _STATE.memo
    if memo is not None and w.key in memo:
        return memo[w.key]
    out = all_gather(w.parts, w.dim, w.home)
    if memo is not None:
        memo[w.key] = out
    return out


def shard_map(fn: Callable, args: tuple, weights: tuple, *,
              split_dims: Optional[tuple] = None, out) -> Any:
    """``fn(*args, *weights)``, per model shard where a weight is a
    :class:`Shards`: shard ``j`` gets part ``j`` of each such weight, the
    arguments (replicated to every shard, or split along
    ``split_dims[i]``) and the other weights (replicated), on its device;
    the results are all-gathered along ``out = ("gather", dim)`` or
    summed (``out = "sum"``).  Without a sharded weight, ``fn`` runs once
    on what it is given."""
    weights = tuple(local(w) if isinstance(w, Shards) and w.gather else w
                    for w in weights)
    sharded = [w for w in weights if isinstance(w, Shards)]
    if not sharded:
        return fn(*args, *weights)
    devices = sharded[0].devices
    split_dims = split_dims or (None,) * len(args)
    per_arg = []
    for a, d in zip(args, split_dims):
        if not isinstance(a, torch.Tensor):
            per_arg.append([a] * len(devices))
        elif d is None:
            per_arg.append(replicate(a, devices))
        else:
            per_arg.append(split(a, d, devices))
    per_w = [w.parts if isinstance(w, Shards)
             else replicate(w, devices) if isinstance(w, torch.Tensor)
             else [w] * len(devices) for w in weights]
    outs = []
    for j, dev in enumerate(devices):
        if j and dev.type == "meta":
            # shapes only (the dry-run): every shard's part has shard 0's
            # shapes, and no collective runs inside a region
            outs.append(outs[0])
            continue
        with on_shard(j, dev):
            outs.append(fn(*(a[j] for a in per_arg), *(w[j] for w in per_w)))
    if out == "sum" and _STATE.seq is not None:
        return SeqSplit(reduce_scatter(outs, 1, devices), devices)
    if out == "sum":
        return all_reduce(outs, devices[0])
    return all_gather(outs, out[1], devices[0])


def einsum(eq: str, x, w, fn: Callable) -> torch.Tensor:
    """The product ``eq`` (an einsum equation ``"x,w->out"``) of ``x`` and
    the weight ``w``, computed by ``fn(x, w)``: on a :class:`Shards` per
    shard, the output all-gathered where the sharded dimension is free,
    the input split and the partial products summed where it is
    contracted (a gathering weight: whole on the home)."""
    if not isinstance(w, Shards) or w.gather:
        return fn(x, local(w))
    xs, rest = eq.split(",")
    ws, os_ = rest.split("->")
    c = ws[w.dim]
    sd = xs.index(c) if c in xs else None
    out = ("gather", os_.index(c)) if c in os_ else "sum"
    return shard_map(fn, (x,), (w,), split_dims=(sd,), out=out)


def embedding(tokens, table) -> torch.Tensor:
    """``F.embedding(tokens, table)``; a table split over ``vocab`` looks
    up the tokens in each shard's range (others read zero) and sums the
    shards, one split over the model dimension is all-gathered (a
    gathering table is looked up whole on the home)."""
    if not isinstance(table, Shards) or table.gather:
        return F.embedding(tokens, local(table))
    devices = table.devices
    if table.dim == 1:
        return all_gather([F.embedding(tokens.to(d), p) for p, d in
                           zip(table.parts, devices)], tokens.dim(),
                          devices[0])
    outs = []
    for j, (p, d) in enumerate(zip(table.parts, devices)):
        n = p.shape[0]
        ids = tokens.to(d) - j * n
        hit = (ids >= 0) & (ids < n)
        e = F.embedding(ids.clamp(0, n - 1), p)
        outs.append(torch.where(hit[..., None], e, torch.zeros((), dtype=e.dtype,
                                                               device=d)))
    return all_reduce(outs, devices[0])


def head_local(params: dict) -> bool:
    """Whether an attention block's ``wq`` is split on ``heads`` and
    ``wk``/``wv`` on ``kv_heads`` (``wo`` then on ``heads``): attention
    runs per shard on its heads."""
    ws = [params.get(k) for k in ("wq", "wk", "wv", "wo")]
    return (all(isinstance(w, Shards) and not w.gather for w in ws)
            and [w.dim for w in ws] == [1, 1, 1, 0])


# ---------------------------------------------------------------------------
# the pieces of a sharded train step
# ---------------------------------------------------------------------------


def grad_leaves(params, groups: List[Group], layout: Layout) -> tuple:
    """``params`` with each shard that ``groups`` read replaced by a fresh
    leaf that requires grad, and per parameter leaf, per group, the
    ``[(position, leaf)]`` to differentiate.  Where the groups overlap
    the model axis, each group reads a model-sharded weight from its line
    through fresh leaves of its own (``ShardedTensor.reads``), so that its
    gradient of the whole weight is its own term."""
    per_leaf = []

    def leaf(x: ShardedTensor):
        shards = x.shards.copy()
        k = layout.model_dim(x)
        mine, reads = [], None
        for g in groups:
            got = []
            if k is not None and layout.overlap:
                got = [(p, x.shards[p].detach().requires_grad_())
                       for p in layout.line(g.positions[0])]
                reads = reads or {}
                reads[g.index] = [t for _, t in got]
            else:
                for pos in (g.positions if k is not None
                            else g.positions[:1]):
                    shards[pos] = x.shards[pos].detach().requires_grad_()
                    got.append((pos, shards[pos]))
            mine.append(got)
        per_leaf.append(mine)
        return ShardedTensor(shards, x.sharding, x.shape, reads)

    return tree.tree_map(leaf, params), per_leaf


def partial_grads(loss, params, per_leaf) -> list:
    """The gradient of ``loss`` with respect to the leaves of
    :func:`grad_leaves`, one :class:`PartialSum` per parameter leaf (a
    leaf the loss does not reach gets zeros)."""
    flat = [t for mine in per_leaf for got in mine for _, t in got]
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    out = []
    for x, mine in zip(tree.leaves(params), per_leaf):
        terms = []
        for got in mine:
            pieces = []
            for pos, t in got:
                g = next(grads)
                pieces.append((x.index(pos),
                               torch.zeros_like(t) if g is None else g))
            terms.append(pieces)
        out.append(PartialSum(terms, x.shape))
    return out


def microbatches(batch, n: int, groups: List[Group]) -> list:
    """``batch`` (ShardedTensors split on dim 0) cut into ``n``
    microbatches of the same layout: microbatch ``i`` holds global rows
    ``[i B/n, (i+1) B/n)``, as the single-device step takes them (one
    all-to-all per leaf)."""
    out = [[] for _ in range(n)]
    for x in tree.leaves(batch):
        B = x.shape[0]
        shape = (B // n,) + tuple(x.shape[1:])
        for i in range(n):
            shards = np.empty(x.shards.shape, dtype=object)
            for want, positions in _wanted(x.sharding, shape).items():
                rows = slice(i * B // n + want[0].start,
                             i * B // n + want[0].stop)
                at = (rows,) + want[1:]
                _copies(assemble(x.pieces(prefer=positions[0], want=at), at,
                                 x.mesh.devices[positions[0]]),
                        positions, x.mesh, shards)
            out[i].append(ShardedTensor(shards, x.sharding, shape))
        record("all-to-all", _nbytes(x.sharding.shard_shape(x.shape),
                                     x.dtype), len(groups))
    return [tree.unflatten(batch, leaves) for leaves in out]


def global_norm(grads, home) -> torch.Tensor:
    """The l2 norm of the global tensors of ``grads`` (ShardedTensors), in
    float32 on ``home``: each distinct shard's squares summed where it
    lies, then one all-reduce."""
    total = None
    for x in tree.leaves(grads):
        for _, t in x.pieces():
            s = torch.sum(torch.square(t.float())).to(home)
            total = s if total is None else total + s
    record("all-reduce", 4, next(iter(tree.leaves(grads))).mesh.size)
    return torch.sqrt(total)


def cast_into(x: ShardedTensor, sh: NamedSharding,
              dtype: torch.dtype) -> ShardedTensor:
    """``x`` cast to ``dtype`` shard by shard, then laid out by ``sh``
    (an all-gather where ``sh`` holds more of a dimension than ``x``)."""
    cast = np.empty(x.shards.shape, dtype=object)
    for pos in _positions(x.mesh):
        cast[pos] = x.shards[pos].to(dtype, copy=True)
    out = _put(ShardedTensor(cast, x.sharding, x.shape), sh)
    k = 1
    for a, b in zip(x.sharding.parts(x.ndim), sh.parts(x.ndim)):
        k *= a // b
    record("all-gather", _nbytes(sh.shard_shape(x.shape), dtype), k)
    return out
