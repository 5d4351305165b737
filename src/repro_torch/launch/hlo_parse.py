"""Structural, loop-aware HLO collective analysis with wire-byte costs
(the port's copy of the reference's text parser), and the same totals
for a :class:`~repro_torch.distributed.spmd.CollectiveLog`.

The parser reads XLA's post-optimisation HLO text (the reference's
archived ``artifacts/hlo/*.hlo.zst``); the port's dry-run
(:mod:`repro_torch.launch.dryrun`) has no HLO and reads its step's
collective log through :func:`log_analysis` instead.

Wire bytes per device for a collective whose HLO OUTPUT is ``out`` bytes
within a replica group of size ``g`` (ring algorithms):

  all-gather          out * (g-1)/g         (output = gathered size)
  reduce-scatter      out * (g-1)            (output = scattered shard)
  all-reduce          out * 2(g-1)/g         (RS + AG)
  all-to-all          out * (g-1)/g
  collective-permute  out                    (point-to-point)

``while``-loop bodies appear once in the text but run trip-count times;
the walk multiplies nested bodies by trip counts recovered from the loop
condition's bound constant (scan trip counts are compile-time constants).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
    "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_WHILE_RE = re.compile(r"condition=%?([\w\-\.]+).*body=%?([\w\-\.]+)")
_GROUPS_BRACE_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def shape_bytes(header: str) -> int:
    n_total = 0
    for dt, dims in _SHAPE_RE.findall(header):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        n_total += n * DTYPE_BYTES[dt]
    return n_total


def group_size(rhs: str, default: int = 2) -> int:
    m = _GROUPS_IOTA_RE.search(rhs)
    if m:
        return max(int(m.group(2)), 1)
    m = _GROUPS_BRACE_RE.search(rhs)
    if m:
        ids = [x for x in m.group(1).split(",") if x.strip()]
        return max(len(ids), 1)
    return default


def wire_bytes(kind: str, out_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return out_bytes * 2 * (g - 1) / g
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


def split_computations(hlo_text: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur, buf = None, []
    header_re = re.compile(r"^(?:ENTRY\s+)?%?([\w\-\.]+)\s*(?:\(.*)?\{")
    for line in hlo_text.splitlines():
        if cur is None:
            m = header_re.match(line.strip())
            if m and line.rstrip().endswith("{"):
                cur, buf = m.group(1), []
                if "ENTRY" in line:
                    cur = "__entry__"
        else:
            if line.strip() == "}":
                comps[cur] = buf
                cur = None
            else:
                buf.append(line.strip())
    return comps


def _loop_totals(name: str, own: tuple, whiles: dict, trip_count,
                 memo: dict) -> tuple:
    """A computation's own (out, wire, count) totals plus each while
    loop's body's totals times its trip count, memoised in ``memo``."""
    if name in memo:
        return memo[name]
    o, w, c = (dict(t.get(name, {k: z for k in COLL_KINDS}))
               for t, z in zip(own, (0.0, 0.0, 0)))
    for cond, body in whiles.get(name, []):
        n = trip_count(cond)
        bo, bw, bc = _loop_totals(body, own, whiles, trip_count, memo)
        for k in COLL_KINDS:
            o[k] += n * bo[k]
            w[k] += n * bw[k]
            c[k] += n * bc[k]
    memo[name] = (o, w, c)
    return memo[name]


def collective_analysis(hlo_text: str) -> dict:
    """Loop-aware totals: raw output bytes AND wire bytes per kind."""
    comps = split_computations(hlo_text)
    own_out = {n: {k: 0.0 for k in COLL_KINDS} for n in comps}
    own_wire = {n: {k: 0.0 for k in COLL_KINDS} for n in comps}
    own_cnt = {n: {k: 0 for k in COLL_KINDS} for n in comps}
    whiles: Dict[str, List[Tuple[str, str]]] = {n: [] for n in comps}

    for name, lines in comps.items():
        for s in lines:
            m = re.match(r"(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.*)", s)
            if not m:
                continue
            rhs = m.group(1)
            if " while(" in rhs or rhs.startswith("while("):
                wm = _WHILE_RE.search(rhs)
                if wm:
                    whiles[name].append((wm.group(1), wm.group(2)))
                continue
            for k in COLL_KINDS:
                if re.search(rf"\b{k}(-start)?\(", rhs):
                    out_b = shape_bytes(rhs[:rhs.find("(")])
                    g = group_size(rhs)
                    own_out[name][k] += out_b
                    own_wire[name][k] += wire_bytes(k, out_b, g)
                    own_cnt[name][k] += 1
                    break

    def trip_count(cond: str) -> int:
        best = 1
        for s in comps.get(cond, []):
            for m in re.finditer(r"constant\((\d+)\)", s):
                best = max(best, int(m.group(1)))
        return best

    own = (own_out, own_wire, own_cnt)
    memo: Dict[str, tuple] = {}
    entry = "__entry__" if "__entry__" in comps else ""
    if entry:
        out, wire, cnt = _loop_totals(entry, own, whiles, trip_count, memo)
    else:
        out = wire = {k: 0.0 for k in COLL_KINDS}
        cnt = {k: 0 for k in COLL_KINDS}
    return {
        "out_bytes": {k: int(v) for k, v in out.items()},
        "wire_bytes": {k: int(v) for k, v in wire.items()},
        "counts": {k: int(v) for k, v in cnt.items()},
        "total_out_bytes": int(sum(out.values())),
        "total_wire_bytes": int(sum(wire.values())),
    }


def log_analysis(log) -> dict:
    """:func:`collective_analysis`'s totals for a collective log (the
    ``(kind, bytes, group)`` entries of ``spmd.CollectiveLog``, one
    device's schedule): output and wire bytes and counts per kind, wire
    bytes by :func:`wire_bytes`.  A loop-free program: each run of a
    collective is its own entry."""
    out = {k: 0 for k in COLL_KINDS}
    wire = {k: 0.0 for k in COLL_KINDS}
    cnt = {k: 0 for k in COLL_KINDS}
    for kind, nbytes, group in log:
        out[kind] += nbytes
        wire[kind] += wire_bytes(kind, nbytes, group)
        cnt[kind] += 1
    return {
        "out_bytes": {k: int(v) for k, v in out.items()},
        "wire_bytes": {k: int(v) for k, v in wire.items()},
        "counts": {k: int(v) for k, v in cnt.items()},
        "total_out_bytes": int(sum(out.values())),
        "total_wire_bytes": int(sum(wire.values())),
    }


def load_hlo(path: str) -> str:
    """The HLO text of an archived ``.hlo.zst`` file (needs the
    ``zstandard`` package, imported here)."""
    try:
        import zstandard as zstd
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the zstandard package, which is not "
            f"installed") from e
    with open(path, "rb") as f:
        return zstd.ZstdDecompressor().decompress(f.read()).decode()
