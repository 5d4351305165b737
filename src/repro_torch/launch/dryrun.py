"""Multi-pod dry-run on meshes of ``meta`` devices: the port's counterpart
of the reference's ``launch/dryrun.py``, which lowers and compiles every
(architecture x input-shape) cell with ``jax.jit`` on 512 forced host
devices.

    python -m repro_torch.launch.dryrun --arch mamba2-370m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--both-meshes]

The port has no compiler to ask, so each cell RUNS its step once on
``make_production_mesh(devices=["meta"] * n)``: every mesh position is a
``meta`` device (shapes and dtypes, no storage), and the executor of
:mod:`repro_torch.distributed.spmd` carries out the step's layouts and
collectives as on cards, allocating nothing.  No card is needed.  On
``meta`` the executor makes each re-laid slice at its shape and lets the
first data group's and model shard's results stand for the others' (the
same shapes), and each operator (each whole call, under ``no_grad``) is
answered from a memo of its output shapes (:class:`MetaRun`): a cell
costs seconds to a minute of host time.  Per cell:

* the step: ``train`` runs ``make_train_step`` (zero1; 8 microbatches
  unless the policy is dp-only), ``prefill`` and ``decode`` the sharded
  ``transformer.prefill``/``decode_step``; the inputs are ``steps.py``'s
  ``meta`` specs laid out by ``make_shardings``, ``choose_pspec``
  (``batch``) and ``cache_layout`` (``cache_pspecs``; under dp-only the
  batch's spec), as the reference's ``in_shardings``;
* ``collectives``: the step's ``CollectiveLog`` (one device's schedule)
  through ``hlo_parse.log_analysis``, under the reference's keys
  ``bytes``, ``counts``, ``total_bytes``, plus ``wire_bytes`` and
  ``total_wire_bytes``;
* ``cost_analysis.flops``: one device's executed matmul FLOPs (the mesh's
  first position's program, forward, backward and recomputation, by
  ``torch.utils.flop_counter``'s formulas).  These are loop-free counts:
  XLA's count takes each ``while`` body once, so on the reference's
  looped lowerings the two differ by the trip counts (the record's
  ``note`` says so);
* ``memory_analysis``: ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, the bytes of mesh position 0's shards (and of
  the step's plain outputs, which live there);
* ``lower_s``: the meta run's seconds (lay-out and step).

Keys of the reference's record with no counterpart here are omitted, as
the reference omits what ``memory_analysis`` lacks: ``compile_s``,
``temp_size_in_bytes``, ``generated_code_size_in_bytes``,
``transcendentals``, ``bytes accessed*``, ``hlo_path``, and the
collectives' ``naive_bytes`` and ``per_computation_naive`` (there are no
loop bodies to count once).

The reference retries a failed ``train`` cell at ``microbatches=1``
because of an XLA SPMD verifier bug (hymba's odd vocabulary at 8
microbatches); the port has no verifier and no such bug, so it keeps the
8 microbatches and does not retry.  ``--set parallel_policy=dp_only``
runs the dp-only policy (the batch over every axis) and ``--set
seq_parallel=true`` sequence parallelism, as in the reference.

The records, file names, printed lines and exit code are the
reference's: ``<out>/<mesh>--<arch>--<shape>[-<tag>].json``, one
``[dryrun] ...`` line per cell, exit code 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_META = torch.device("meta")

OMITTED = ("compile_s", "temp_size_in_bytes",
           "generated_code_size_in_bytes", "transcendentals",
           "bytes accessed", "hlo_path", "naive_bytes",
           "per_computation_naive")
NOTE = ("loop-free counts: cost_analysis.flops is one device's executed "
        "matmul FLOPs and collectives each run of a collective; XLA's "
        "counts take each while body once")


# ---------------------------------------------------------------------------
# running on meta: memoised shapes and one device's FLOPs
# ---------------------------------------------------------------------------


def _sig(args) -> tuple:
    """A signature of an op's arguments: each tensor's shape, strides and
    dtype (``TypeError`` if one is not on ``meta``), other values as they
    are (unhashable ones raise ``TypeError`` at the memo's lookup)."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise TypeError("not a meta tensor")
            out.append((x.shape, x.stride(), x.dtype))
        elif isinstance(x, (list, tuple)):
            out.append(_sig(x))
        else:
            out.append(x)
    return tuple(out)


def _describe(out):
    if isinstance(out, torch.Tensor):
        if not out.is_meta:
            raise TypeError("not a meta tensor")
        return ("T", tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return tuple(_describe(o) for o in out)
    raise TypeError("not a tensor output")


def _build(meta):
    """Fresh ``meta`` tensors of the shapes ``_describe`` gave (made with
    the modes off: no memo, no count)."""
    with torch._C.DisableTorchFunction(), torch._C._DisableTorchDispatch():
        return _make(meta)


def _make(meta):
    if meta and meta[0] == "T":
        return torch.empty_strided(meta[1], meta[2], dtype=meta[3],
                                   device=_META)
    return tuple(_make(m) for m in meta)


def _memo_entry(func, out, args):
    """How to answer ``func`` again on the same signature: ``("new",
    shapes)`` for a fresh output, ``("self", None)`` for an in-place op
    that returns its first argument, ``("none", None)`` for one that
    returns nothing; ``None`` for views and anything else (run every
    time)."""
    schema = func._schema
    rets = schema.returns
    if schema.is_mutable:
        if not rets:
            return ("none", None)
        a0 = schema.arguments[0].alias_info if schema.arguments else None
        r0 = rets[0].alias_info
        if (len(rets) == 1 and r0 is not None and a0 is not None
                and r0.before_set == a0.before_set and out is args[0]):
            return ("self", None)
        return None
    if any(r.alias_info is not None for r in rets):
        return None
    try:
        return ("new", _describe(out))
    except TypeError:
        return None


class MetaRun(TorchDispatchMode):
    """Runs a program on ``meta`` tensors, answering each operator from a
    memo of its outputs' shapes per input signature (``meta`` kernels are
    functions of shapes, dtypes and arguments; most run in Python and
    cost 100 us each), and counts the matmul FLOPs of the logged
    device's program (``spmd.logged()``: the first data group's home,
    model shard 0; in a backward pass, or a checkpoint's recomputation
    inside it, every operator that runs)."""

    def __init__(self):
        super().__init__()
        self.memo = {}
        self.flops = 0
        self.raw = 0      # every program's FLOPs (for _CallMemo)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.distributed import spmd

        kwargs = kwargs or {}
        try:
            key = (func, _sig(args), _sig(kwargs.values()),
                   tuple(kwargs))
            got = self.memo.get(key)
        except TypeError:
            key = got = None
        packet = func._overloadpacket
        if got is None:
            out = func(*args, **kwargs)
            flops = (int(flop_registry[packet](*args, **kwargs, out_val=out))
                     if packet in flop_registry else 0)
            if key is not None:
                entry = _memo_entry(func, out, args)
                if entry is not None:
                    self.memo[key] = entry + (flops,)
        else:
            flops = got[-1]
            out = (args[0] if got[0] == "self" else None if got[0] == "none"
                   else _build(got[1]))
        if flops:
            self.raw += flops
            # a backward pass (an autograd node runs) is the logged
            # program's: on meta the other groups' and shards' parts are
            # elided (spmd.per_group, spmd.shard_map)
            if (torch._C._current_autograd_node() is not None
                    or spmd.logged()):
                self.flops += flops
        return out


class _CallMemo(TorchFunctionMode):
    """Under ``torch.no_grad`` (prefill and decode), answers a whole torch
    function (an ``einsum``, a method) on ``meta`` arguments from a memo
    of its outputs' shapes per signature, with the FLOPs its first call
    counted (added when the logged device's program calls it again), so
    that the operators it decomposes into are not dispatched one by one.
    In-place methods (``name_``) return their tensor.  On ``meta`` no
    tensor holds data, so a fresh output stands for a view as well."""

    def __init__(self, run: MetaRun):
        super().__init__()
        self.run = run
        self.memo = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from repro_torch.distributed import spmd

        kwargs = kwargs or {}
        try:
            key = (func, _sig(args), _sig(kwargs.values()), tuple(kwargs))
            got = self.memo.get(key)
        except TypeError:
            return func(*args, **kwargs)
        if got is not None:
            kind, meta, flops = got
            if flops and spmd.logged():
                self.run.flops += flops
            if kind == "self":
                return args[0]
            out = _build(meta[1])
            return meta[0](out) if meta[0] is not None else out
        before = self.run.raw
        out = func(*args, **kwargs)
        flops = self.run.raw - before
        name = getattr(func, "__name__", "")
        if (name.endswith("_") and not name.endswith("__") and args
                and out is args[0]):
            self.memo[key] = ("self", None, flops)
            return out
        try:
            meta = _describe(out)
        except TypeError:
            return out
        kind = type(out) if (isinstance(out, (tuple, list))
                             and type(out) is not tuple) else None
        self.memo[key] = ("new", (kind, meta), flops)
        return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _local_bytes(t) -> int:
    """Bytes of mesh position 0's shards of ``t``'s ShardedTensor leaves
    and of its plain tensor leaves."""
    from repro_torch import tree
    from repro_torch.distributed import spmd

    total = 0
    for x in tree.leaves(t):
        if isinstance(x, spmd.ShardedTensor):
            x = x.shards.flat[0]
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def measure(cfg, shape, mesh, tcfg, *, ctx_kw=None, model_kw=None) -> dict:
    """Run the cell's step once on ``mesh`` (of ``meta`` devices) under
    ``mesh_context(mesh, **ctx_kw)``: the record's measured fields."""
    from repro_torch import tree
    from repro_torch.distributed import NamedSharding, mesh_context, spmd
    from repro_torch.distributed.sharding import choose_pspec
    from repro_torch.launch.hlo_parse import log_analysis
    from repro_torch.launch.steps import cache_layout, make_step
    from repro_torch.train.trainer import make_shardings

    t0 = time.time()
    run = MetaRun()
    calls = (contextlib.nullcontext() if shape.kind == "train"
             else _CallMemo(run))
    with mesh_context(mesh, **(ctx_kw or {})), run, calls:
        step_fn, specs = make_step(cfg, shape, tcfg, **(model_kw or {}))
        p_shard, o_shard = make_shardings(cfg, tcfg, mesh)

        def b_shard(x):
            return NamedSharding(mesh, choose_pspec(
                x.shape, ("batch",) + (None,) * (x.dim() - 1), mesh))

        params = spmd.device_put(specs["params"], p_shard)
        if shape.kind == "train":
            args = (params, spmd.device_put(specs["opt"], o_shard),
                    spmd.device_put(specs["batch"], tree.tree_map(
                        b_shard, specs["batch"])))
        elif shape.kind == "prefill":
            args = (params, spmd.device_put(specs["batch"], tree.tree_map(
                b_shard, specs["batch"])))
        else:
            cache_sh = type(specs["caches"])(*(
                None if cs is None else type(cs)(*(NamedSharding(mesh, p)
                                                   for p in cs))
                for cs in cache_layout(cfg, mesh, shape.global_batch)))
            args = (params, spmd.device_put(specs["tokens"],
                                            b_shard(specs["tokens"])),
                    spmd.device_put(specs["caches"], cache_sh))
        run.flops = 0
        log = spmd.CollectiveLog()
        with spmd.recording(log):
            out = step_fn(*args)
        if shape.kind == "train":
            log = out[2]["collectives"]
            out = (out[0], out[1], {k: v for k, v in out[2].items()
                                    if k != "collectives"})
    coll = log_analysis(log)
    return {
        "lower_s": round(time.time() - t0, 2),
        "memory_analysis": {
            "argument_size_in_bytes": _local_bytes(args),
            "output_size_in_bytes": _local_bytes(out),
        },
        "cost_analysis": {"flops": float(run.flops)},
        "collectives": {
            "bytes": coll["out_bytes"],
            "counts": coll["counts"],
            "total_bytes": coll["total_out_bytes"],
            "wire_bytes": coll["wire_bytes"],
            "total_wire_bytes": coll["total_wire_bytes"],
        },
        "num_devices": mesh.devices.size,
        "note": NOTE,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str, model_kw: dict | None = None,
             tag: str = "", overrides: dict | None = None,
             microbatches: int | None = None) -> dict:
    from repro_torch.config import (
        SHAPE_SUITE, TrainConfig, get_config, shape_skip_reason)
    from repro_torch.distributed.sharding import policy_kw
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            if isinstance(cur, bool):
                typed[k] = str(v).lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                typed[k] = int(v)
            elif isinstance(cur, float):
                typed[k] = float(v)
            else:
                typed[k] = v
        cfg = dataclasses.replace(cfg, **typed)
    shape = next(s for s in SHAPE_SUITE if s.name == shape_name)
    mesh_name = "pod512" if multi_pod else "pod256"
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tag": tag,
        "overrides": dict(overrides or {}),
    }
    reason = shape_skip_reason(cfg, shape)
    if reason:
        record["status"] = "skipped"
        record["skip_reason"] = reason
        return record

    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    dp_only = cfg.parallel_policy == "dp_only"
    default_mb = 8 if (shape.kind == "train" and not dp_only) else 1
    tcfg = TrainConfig(zero1=True, microbatches=microbatches or default_mb)
    try:
        record.update(measure(cfg, shape, mesh, tcfg,
                              ctx_kw=policy_kw(cfg.parallel_policy),
                              model_kw=model_kw))
        record["status"] = "ok"
    except Exception as e:  # record the failure; the suite reports it
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    return record


def _write(record, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    tag = f"-{record['tag']}" if record.get("tag") else ""
    path = os.path.join(
        out_dir,
        f"{record['mesh']}--{record['arch']}--{record['shape']}{tag}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--causal-skip", action="store_true",
                    help="triangular causal schedule (perf variant)")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig override key=value (repeatable), "
                         "e.g. --set seq_parallel=true")
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in getattr(args, "set"))

    from repro_torch.config import SHAPE_SUITE
    from repro_torch.configs import ARCHS

    cells = []
    if args.all:
        for arch in ARCHS:
            for s in SHAPE_SUITE:
                cells.append((arch, s.name))
    else:
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    model_kw = {"causal_skip": True} if args.causal_skip else None
    failures = 0
    for multi_pod in meshes:
        for arch, shape in cells:
            rec = run_cell(arch, shape, multi_pod, args.out,
                           model_kw=model_kw, tag=args.tag,
                           overrides=overrides,
                           microbatches=args.microbatches)
            _write(rec, args.out)
            status = rec["status"]
            extra = ""
            if status == "ok":
                extra = (f" flops={rec['cost_analysis'].get('flops', 0):.3g}"
                         f" coll={rec['collectives']['total_bytes']:.3g}B"
                         f" lower={rec['lower_s']}s")
            elif status == "failed":
                failures += 1
                extra = " " + rec["error"][:160]
            print(f"[dryrun] {rec['mesh']} {arch} {shape}: "
                  f"{status}{extra}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
