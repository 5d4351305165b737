"""The port's whole-scan ``lqt_combine`` kernel module
(``repro_torch.kernels.lqt_combine.scan``) on the CPU.

On the CPU the scan wrapper runs its plain version (``ref.lqt_scan_ref``,
the core associative scan: the kernel's tree), so these tests hold the
port's ``kernel_suffix_scan`` / ``kernel_prefix_scan``, the wrapper and the
plain scan against the JAX package's scans at 1e-9: its whole-scan Pallas
kernel path run in interpret mode (as the reference's kernel tests run it)
and its ``repro.core.pscan`` scans with the jnp combine.  The reference's
interpret-mode scan compiles for seconds per shape, so it is run at nx = 1;
the jnp scans, jitted and sequential (one compiled fold per shape), cover
the other sizes.  They also check the wrapper's validation, that the CPU
path launches nothing, that the estimation path hands the kernel its
elements without copies, and the build's source hash.  The CUDA kernel
itself is compared with its plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clear_cache as jclear_cache
from repro.core import pscan as jpscan
from repro.core.combine import lqt_combine as jcombine
from repro.core.types import LQTElement as JElem
from repro.kernels.lqt_combine import kernel_prefix_scan as j_kprefix
from repro.kernels.lqt_combine import kernel_suffix_scan as j_ksuffix
from repro_torch.core.types import LQTElement
from repro_torch.kernels import _build
from repro_torch.kernels.lqt_combine import kernel as tkernel
from repro_torch.kernels.lqt_combine import ops as tops
from repro_torch.kernels.lqt_combine import scan as tscan
from repro_torch.kernels.lqt_combine.ref import lqt_scan_ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-9)
# float32 scan of float64 elements, held to the float64 reference
TOL32 = dict(rtol=2e-4, atol=2e-4)
RECORDS = (2, 3)


def _psd(rng, shape, n):
    A = rng.standard_normal(shape + (n, n))
    return np.einsum("...ij,...kj->...ik", A, A) / n + 0.1 * np.eye(n)


def _elems(seed, n, nx, records=RECORDS):
    """Elements (n, *records, ...) with PSD C and J, as the reference's
    kernel tests build them (every Gauss-Jordan pivot >= 1)."""
    rng = np.random.default_rng(seed)
    sh = (n,) + tuple(records)
    return (rng.standard_normal(sh + (nx, nx)) * 0.6,
            rng.standard_normal(sh + (nx,)), _psd(rng, sh, nx),
            rng.standard_normal(sh + (nx,)), _psd(rng, sh, nx))


def _port(arrs, index=()):
    """The port's elements for records ``index`` of the arrays: a view of
    one tensor, as a caller's records would be."""
    full = LQTElement(*(torch.from_numpy(a) for a in arrs))
    return LQTElement(*(a[(slice(None),) + index] for a in full))


def _close(got, want, index=(), **tol):
    for g, w in zip(tuple(got), tuple(want)):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w)[(slice(None),) + index],
            **(tol or TOL))


def _ports():
    """The three port surfaces that run a scan: ``(name, fn(elems,
    reverse))``."""
    def ops(e, reverse, **kw):
        fn = tops.kernel_suffix_scan if reverse else tops.kernel_prefix_scan
        return fn(e, **kw)

    return {"ops": ops,
            "wrapper": lambda e, reverse: tscan.lqt_scan(e, reverse=reverse),
            "plain": lambda e, reverse: lqt_scan_ref(e, reverse=reverse)}


# The reference's scans, jitted: each shape compiles once per process.
_j_seq = {rev: jax.jit(functools.partial(
    jpscan.suffix_scan if rev else jpscan.prefix_scan, jcombine,
    sequential=True)) for rev in (False, True)}
_j_kernel = {rev: jax.jit(functools.partial(
    j_ksuffix if rev else j_kprefix, block_b=8, interpret=True))
    for rev in (False, True)}


def _check_all_records(arrs, want, reverse, **tol):
    """Every port surface at records (), (3,) and (2, 3) (views of one
    tensor) against the reference's result on the whole batch."""
    launches = tscan.launch_count(), tkernel.launch_count()
    for fn in _ports().values():
        for index in ((0, 0), (1,), ()):
            _close(fn(_port(arrs, index), reverse), want, index, **tol)
    assert (tscan.launch_count(), tkernel.launch_count()) == launches


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 65])
@pytest.mark.parametrize("reverse", [False, True])
def test_scans_match_reference_pscan_nx4(n, reverse):
    arrs = _elems(n, n, 4)
    want = _j_seq[reverse](JElem(*map(jnp.asarray, arrs)))
    _check_all_records(arrs, want, reverse)


@pytest.mark.parametrize("n,nx", [(5, 1), (65, 1), (17, 5), (65, 5)])
@pytest.mark.parametrize("reverse", [False, True])
def test_scans_match_reference_pscan_other_nx(n, nx, reverse):
    arrs = _elems(100 + n + nx, n, nx)
    want = _j_seq[reverse](JElem(*map(jnp.asarray, arrs)))
    _check_all_records(arrs, want, reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_scans_match_reference_kernel_scan_interpret(reverse):
    """Against the reference's whole-scan Pallas path (interpret mode),
    record by record: it takes one record per call."""
    arrs = _elems(7, 3, 1)
    launches = tscan.launch_count(), tkernel.launch_count()
    for index in ((0, 0), (1, 2)):
        one = [a[(slice(None),) + index] for a in arrs]
        want = _j_kernel[reverse](JElem(*map(jnp.asarray, one)))
        for fn in _ports().values():
            _close(fn(_port(arrs, index), reverse), want)
    assert (tscan.launch_count(), tkernel.launch_count()) == launches


@pytest.mark.parametrize("reverse", [False, True])
def test_precision_float32_cast(reverse):
    """``precision="float32"`` scans in float32 and returns float64, within
    float32 round-off of the float64 reference."""
    arrs = _elems(11, 17, 4)
    want = _j_seq[reverse](JElem(*map(jnp.asarray, arrs)))
    fn = tops.kernel_suffix_scan if reverse else tops.kernel_prefix_scan
    got = fn(_port(arrs), precision="float32")
    assert all(g.dtype == torch.float64 for g in got)
    _close(got, want, **TOL32)


def test_tree_depth_and_scratch():
    assert [tscan.tree_depth(n) for n in (1, 2, 3, 4, 513, 2049)] == [
        0, 1, 1, 2, 9, 11]
    # levels 1..L: 1024 + 512 + ... + 1 = 2047 elements per record
    assert tscan.scratch_elements(2049, 64) == 64 * 2047
    assert tscan.scratch_elements(1, 5) == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    e = _port(_elems(0, 5, 3))
    assert tscan._check(e) == (5, (2, 3), 3)
    bad = {
        "float32 or float64": LQTElement(*(a.to(torch.float16) for a in e)),
        "operand 1": e._replace(b=e.b[..., :2]),
        "operand 4": e._replace(J=e.J[1:]),
        r"1 <= nx": _port(_elems(0, 5, 9)),
        r"\(n, \*R, nx, nx\)": e._replace(A=e.A[..., :2]),
        "all operands": e._replace(C=e.C.to(torch.float32)),
    }
    for match, x in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            tscan._check(x)
    with pytest.raises(ValueError, match="LQTElement"):
        tscan._check(tuple(e)[:4])
    meta = LQTElement(*(a.to("meta") for a in e))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscan.lqt_scan(meta)
    mixed = e._replace(C=e.C.to("meta"))
    with pytest.raises(ValueError, match="all operands"):
        tscan._check(mixed)


def test_natural_views_need_no_copy():
    """Records of any view that merges into one stride are read in place;
    only a layout the kernel cannot address is made dense."""
    x = torch.zeros(7, 2, 3, 4, 4, dtype=torch.float64)
    v, se, sr = tscan._natural(x, 7, 6, True)
    assert v.data_ptr() == x.data_ptr() and (se, sr) == (96, 16)
    sub = x[:, 1]                                  # (7, 3, 4, 4) view
    v, se, sr = tscan._natural(sub, 7, 3, True)
    assert v.data_ptr() == sub.data_ptr() and (se, sr) == (96, 16)
    bcast = torch.zeros(7, 1, 4).expand(7, 5, 4)   # records of stride 0
    v, se, sr = tscan._natural(bcast, 7, 5, False)
    assert v.data_ptr() == bcast.data_ptr() and (se, sr) == (4, 0)
    tr = x.transpose(-1, -2)                       # inner dims not dense
    v, _, _ = tscan._natural(tr, 7, 6, True)
    assert v.data_ptr() != tr.data_ptr() and torch.equal(
        v.reshape(tr.shape), tr)


@pytest.mark.parametrize("layout", ["single", "stacked"])
def test_estimation_path_hands_the_scan_views(monkeypatch, layout):
    """``parallel_kernel``'s backward scan gets elements the kernel reads
    in place (no copy before the launch), and one scan per solve."""
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (Estimator, KernelOptions, Problem,
                                  simulate_linear, time_grid)

    seen = []
    real = tops.kernel_suffix_scan

    def spy(elems, **kw):
        seen.append(elems)
        return real(elems, **kw)

    monkeypatch.setattr(tops, "kernel_suffix_scan", spy)
    cfg = WienerVelocityConfig()
    model = cfg.model(dtype=torch.float64, device="cpu")
    ts = time_grid(cfg.t0, cfg.tf, 40, device="cpu")
    g = torch.Generator().manual_seed(0)
    if layout == "single":
        _, y = simulate_linear(model, ts, g)
        p = Problem.single(model, ts, y)
    else:
        _, y = simulate_linear(model, ts[:, None].expand(-1, 3), g)
        p = Problem.stacked(model, ts, y.movedim(1, 0))
    Estimator(model, method="parallel_kernel",
              options=KernelOptions(nsub=5, mode="discrete"),
              device="cpu").solve(p)
    assert len(seen) == 1
    n, rec, _ = tscan._check(seen[0])
    R = int(np.prod(rec))
    for x, mat in zip(seen[0], tkernel._MAT):
        v, _, _ = tscan._natural(x, n, R, mat)
        assert v.data_ptr() == x.data_ptr()


def test_build_hash_covers_local_headers(tmp_path):
    """An edit to ``lqt_combine.cuh`` renames both libraries that include
    it (the build would otherwise load a stale library); an edit elsewhere
    does not."""
    csrc = tscan.SOURCE.parent
    for f in csrc.iterdir():
        (tmp_path / f.name).write_text(f.read_text())
    scan_src, pair_src = tmp_path / "lqt_scan.cu", tmp_path / "lqt_combine.cu"
    assert _build.local_headers(scan_src) == [tmp_path / "lqt_combine.cuh"]
    assert _build.local_headers(pair_src) == [tmp_path / "lqt_combine.cuh"]
    before = (_build.source_digest(scan_src), _build.source_digest(pair_src))
    assert before == (_build.source_digest(tscan.SOURCE),
                      _build.source_digest(tkernel.SOURCE))
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    assert (_build.source_digest(scan_src),
            _build.source_digest(pair_src)) == before
    hdr = tmp_path / "lqt_combine.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = (_build.source_digest(scan_src), _build.source_digest(pair_src))
    assert after[0] != before[0] and after[1] != before[1]


def test_no_build_at_import_and_ptxas_parse():
    assert tscan.SOURCE.is_file() and tscan._lib is None
    log = (
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__f955a511"
        "_11_lqt_scan_cu_5d5bad5b15lqt_scan_kernelILi5EdEEvNS_8ScanArgsIT0"
        "_EE' for 'sm_90a'\n"
        "    104 bytes stack frame, 116 bytes spill stores, 176 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n")
    assert tscan._parse_ptxas(log) == [{
        "nx": 5, "dtype": "float64", "spill_stores": 116,
        "spill_loads": 176, "registers": 255}]


@pytest.fixture(scope="module", autouse=True)
def _release_reference_executables():
    """Drop the JAX executables this module compiled once it ends: each
    holds memory maps, and a test process that kept every module's
    executables would reach the kernel's per-process map limit."""
    yield
    jclear_cache()
    jax.clear_caches()
    gc.collect()
