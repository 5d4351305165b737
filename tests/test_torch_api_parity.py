"""Static API parity of the port with the JAX package.

Every public module, name, package export, class method or field and
parameter name of ``src/repro/`` has a counterpart of the same name in the
same place under ``src/repro_torch/``, except for the differences listed
in ``ALLOWED``, each with its reason and the test or ``ROADMAP.md`` item
that pins it.  The port may have more than the reference; it may not have
less.  The comparison reads the sources' syntax trees only: neither
package is imported, so the file takes about a second.
"""
from __future__ import annotations

import ast
import fnmatch
from pathlib import Path
from typing import NamedTuple, Optional

import pytest

SRC = Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"


class Allowed(NamedTuple):
    kind: str       # module, name, method, field or param
    where: str      # a pattern of the location ("module path[:qualname]")
    name: str       # a pattern of the missing name
    port: Optional[str]   # the port counterpart's name, where it has one
    reason: str
    pinned: str


ALLOWED = (
    Allowed("module", "kernels/_compat.py", "*", None,
            "shims Pallas's CompilerParams across jax versions; the CUDA "
            "kernels have no Pallas",
            "ROADMAP.md queue 2 (TPU kernels still to port: none)"),
    Allowed("param", "*", "key", "generator",
            "random draws take a torch.Generator, not a JAX PRNG key",
            "ROADMAP.md queue 3 (differences kept on purpose)"),
    Allowed("param", "*", "interpret", None,
            "no Pallas interpreter: a CPU tensor runs the plain version",
            "tests/test_torch_estimator.py::test_methods_and_options"),
    Allowed("field", "core/options.py:KernelOptions", "interpret", None,
            "no Pallas interpreter: a CPU tensor runs the plain version",
            "tests/test_torch_estimator.py::test_methods_and_options"),
    Allowed("method", "core/options.py:KernelOptions", "resolve_interpret",
            None, "resolves the absent interpret field",
            "tests/test_torch_estimator.py::test_methods_and_options"),
    Allowed("param", "*", "block_b", "block_size",
            "a CUDA launch takes threads per block, not a Pallas tile",
            "tests/test_torch_estimator.py::test_methods_and_options"),
    Allowed("param", "kernels/flash_attention/*", "block_[qk]", None,
            "the CUDA kernel's tiles are fixed by its variant (mma, simt)",
            "tests/test_torch_lm_kernels.py::"
            "test_flash_plain_matches_pallas_interpret"),
    Allowed("param", "obs/tracing.py:trace_span", "xla", "record_function",
            "a span marks a torch.profiler range, not an XLA trace",
            "tests/test_torch_obs.py::"
            "test_torch_profile_writes_trace_with_labelled_spans"),
    Allowed("name", "obs/*.py", "xla_profile", "torch_profile",
            "the profiler is torch.profiler's, not XLA's",
            "tests/test_torch_obs.py::test_public_surface_matches_reference"),
    Allowed("param", "core/pscan.py:distributed_scan", "elems", "shards",
            "one process drives every shard: it takes the shards, not a "
            "shard_map body's local block",
            "tests/test_torch_distributed.py::"
            "test_distributed_scan_lqt_prefix_matches_plain_scan"),
    Allowed("param", "core/pscan.py:distributed_scan", "axis_name", "shards",
            "no named axis inside a shard_map body: the shards are given",
            "tests/test_torch_distributed.py::"
            "test_distributed_scan_lqt_prefix_matches_plain_scan"),
    Allowed("name", "models/ssm.py", "ssd_scan_jnp", None,
            "its gradient is nan at hymba's chunk; the port differentiates "
            "kernels/ssd/ref.py::ssd_scan_chunked",
            "tests/test_torch_train.py::"
            "test_ssd_backward_is_finite_where_the_reference_plain_"
            "gradient_is_not"),
    Allowed("*", "*", "_*", None,
            "private helpers (one leading underscore) are each package's "
            "own", "this file: public names only are held"),
)


def _private(name: str) -> bool:
    return name.startswith("_") and not (name.startswith("__")
                                         and name.endswith("__"))


def _statements(body):
    """Module-level statements, looking inside ``if`` and ``try``."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _statements(s.body)
            yield from _statements(s.orelse)
        elif isinstance(s, ast.Try):
            for part in (s.body, *(h.body for h in s.handlers), s.orelse,
                         s.finalbody):
                yield from _statements(part)
        else:
            yield s


def _params(fn) -> list:
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    out += ["*" + x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [p for p in out if p not in ("self", "cls")]


class Module:
    """The names a module binds at its top level."""

    def __init__(self, path: Path, root: Path):
        self.path, self.root = path, root
        self.defs, self.imports, self.assigns = {}, {}, set()
        self.all = []
        for s in _statements(ast.parse(path.read_text()).body):
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                self.defs[s.name] = s
            elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                for t in (s.targets if isinstance(s, ast.Assign)
                          else [s.target]):
                    self.assigns |= {n.id for n in ast.walk(t)
                                     if isinstance(n, ast.Name)}
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        self.all = [e.value for e in s.value.elts]
            elif isinstance(s, ast.ImportFrom):
                for a in s.names:
                    self.imports[a.asname or a.name] = (s.level, s.module,
                                                        a.name)
            elif isinstance(s, ast.Import):
                for a in s.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        0, a.name, None)

    @property
    def package(self) -> bool:
        return self.path.name == "__init__.py"

    def bound(self) -> set:
        return set(self.defs) | self.assigns | set(self.imports) | set(
            self.all)

    def public(self) -> set:
        """What the module offers: its definitions, and for a package its
        exports (``__all__`` and what it imports from its own package)."""
        out = set(self.defs) | self.assigns
        if self.package:
            out |= set(self.all) | {
                n for n, (level, mod, _) in self.imports.items()
                if level or (mod or "").split(".")[0] == self.root.name}
        return out - {"__all__"}


_MODULES = {}


def _module(path: Path, root: Path) -> Optional[Module]:
    if path not in _MODULES:
        _MODULES[path] = Module(path, root) if path.exists() else None
    return _MODULES[path]


def _resolve(mod: Module, name: str, depth: int = 0):
    """The definition that ``name`` in ``mod`` is, following imports
    within the package; None where it is no def or class of it."""
    if name in mod.defs:
        return mod.defs[name]
    if name not in mod.imports or depth > 8:
        return None
    level, target, orig = mod.imports[name]
    if orig is None:
        return None
    if level:
        base = mod.path.parent
        for _ in range(level - 1):
            base = base.parent
    elif (target or "").split(".")[0] == mod.root.name:
        base, target = mod.root, target.partition(".")[2]
    else:
        return None
    stem = base.joinpath(*[p for p in (target or "").split(".") if p])
    for path in (stem.with_suffix(".py"), stem / "__init__.py"):
        other = _module(path, mod.root)
        if other is not None:
            return _resolve(other, orig, depth + 1)
    return None


def _class_names(mod: Module, cls: ast.ClassDef, depth: int = 0) -> dict:
    """``{name: node}`` of a class's methods, fields and attributes set in
    its methods, its bases' (within the package) included."""
    out = {}
    for s in cls.body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(s.name, s)
            for n in ast.walk(s):
                if (isinstance(n, ast.Attribute) and isinstance(n.ctx,
                                                                ast.Store)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"):
                    out.setdefault(n.attr, n)
        elif isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name):
            out.setdefault(s.target.id, s)
        elif isinstance(s, ast.Assign):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, s)
    for b in cls.bases:
        if isinstance(b, ast.Name) and depth < 8:
            base = _resolve(mod, b.id)
            if isinstance(base, ast.ClassDef):
                for k, v in _class_names(mod, base, depth + 1).items():
                    out.setdefault(k, v)
    return out


def _fields(cls: ast.ClassDef) -> list:
    return [s.target.id for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target,
                                                           ast.Name)]


def differences(ref_root: Path = REF, port_root: Path = PORT) -> list:
    """``[(kind, location, name)]``: what the reference offers and the port
    lacks."""
    out = []
    for path in sorted(ref_root.rglob("*.py")):
        rel = path.relative_to(ref_root).as_posix()
        ref = _module(path, ref_root)
        port = _module(port_root / rel, port_root)
        if port is None:
            out.append(("module", rel, "*"))
            continue
        for name in sorted(ref.public()):
            if name not in port.bound():
                out.append(("name", rel, name))
        for name, node in ref.defs.items():
            if _private(name):
                continue
            there = _resolve(port, name)
            if isinstance(node, ast.ClassDef) and isinstance(there,
                                                             ast.ClassDef):
                have = _class_names(port, there)
                for s in node.body:
                    if isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) and not (
                                          _private(s.name)):
                        if s.name not in have:
                            out.append(("method", f"{rel}:{name}", s.name))
                        elif isinstance(have[s.name], (
                                ast.FunctionDef, ast.AsyncFunctionDef)):
                            got = _params(have[s.name])
                            out += [("param", f"{rel}:{name}.{s.name}", p)
                                    for p in _params(s) if p not in got]
                for field in _fields(node):
                    if field not in have:
                        out.append(("field", f"{rel}:{name}", field))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and isinstance(there, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                got = _params(there)
                out += [("param", f"{rel}:{name}", p) for p in _params(node)
                        if p not in got]
    return out


def _allowed_by(diff) -> list:
    kind, where, name = diff
    rel, _, qual = where.partition(":")
    loc = f"{rel}:{qual.split('.')[0]}"       # a method's class
    return [a for a in ALLOWED
            if a.kind in (kind, "*") and fnmatch.fnmatchcase(name, a.name)
            and (fnmatch.fnmatchcase(where, a.where)
                 or fnmatch.fnmatchcase(loc, a.where))]


@pytest.fixture(scope="module")
def diffs():
    return differences()


@pytest.mark.parametrize("kind", ["module", "name", "method", "field",
                                  "param"])
def test_every_reference_api_has_a_port_counterpart(diffs, kind):
    missing = [d for d in diffs if d[0] == kind and not _allowed_by(d)]
    assert missing == [], (f"{len(missing)} public {kind}s of src/repro "
                           f"have no counterpart in src/repro_torch: "
                           f"{missing}")


def test_every_allowed_difference_is_used_and_has_its_counterpart(diffs):
    """The table holds no stale entry, and where an entry names the
    port's replacement, the port has it in place of the missing name."""
    for a in ALLOWED:
        hits = [d for d in diffs if a in _allowed_by(d)]
        assert hits, f"stale entry {a}"
        assert a.reason and a.pinned
        if a.port is None:
            continue
        for kind, where, _ in hits:
            rel, _, qual = where.partition(":")
            port = _module(PORT / rel, PORT)
            if kind == "name":
                assert a.port in port.bound(), (a, where)
                continue
            head, _, meth = qual.partition(".")
            node = _resolve(port, head)
            if meth:
                node = _class_names(port, node)[meth]
            assert a.port in _params(node), (a, where)


def test_the_comparison_sees_a_planted_difference(tmp_path):
    """A module, a name, an export, a method, a field and a parameter that
    a port copy lacks are each reported; private names are not compared
    as public ones."""
    ref, port = tmp_path / "ref", tmp_path / "ref_torch"
    for root in (ref, port):
        (root / "sub").mkdir(parents=True)
    (ref / "__init__.py").write_text("from . import sub\n")
    (port / "__init__.py").write_text("")
    (ref / "gone.py").write_text("X = 1\n")
    (ref / "sub" / "__init__.py").write_text("from .m import f, C\n")
    (port / "sub" / "__init__.py").write_text("from .m import f\n")
    body = ("def f(a, *, b=1):\n    pass\n"
            "def _helper():\n    pass\n"
            "class C:\n    n: int\n    def run(self, x):\n        pass\n"
            "    def stop(self):\n        pass\n")
    (ref / "sub" / "m.py").write_text(body + "Y = 2\n")
    (port / "sub" / "m.py").write_text(
        "from .impl import f\n"
        "class C:\n    def run(self, y):\n        pass\n")
    (port / "sub" / "impl.py").write_text("def f(a):\n    pass\n")
    _MODULES.clear()
    got = set(differences(ref, port))
    _MODULES.clear()
    assert got == {
        ("module", "gone.py", "*"),
        ("name", "__init__.py", "sub"),
        ("name", "sub/__init__.py", "C"),
        ("name", "sub/m.py", "Y"),
        ("name", "sub/m.py", "_helper"),
        ("param", "sub/m.py:f", "b"),
        ("method", "sub/m.py:C", "stop"),
        ("param", "sub/m.py:C.run", "x"),
        ("field", "sub/m.py:C", "n"),
    }
    assert _allowed_by(("name", "sub/m.py", "_helper"))
    assert not _allowed_by(("name", "sub/m.py", "Y"))
