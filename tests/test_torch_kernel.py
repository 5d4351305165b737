"""The port's ``lqt_combine`` kernel module (``repro_torch.kernels``).

On the CPU the wrapper runs its plain version, so these tests hold the
port's lane-major drivers (``ops.py``) against the JAX Pallas kernel run in
interpret mode, as the reference's own kernel tests run it, at 1e-9; port
the reference's hypothesis properties onto the plain version; and check
the wrapper's input validation.  The CUDA kernel itself is compared with
its plain version on the card (``test_kernel_matches_plain_on_card`` and
``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import LQTElement as JElem
from repro.kernels.lqt_combine import kernel_suffix_scan as j_suffix
from repro.kernels.lqt_combine.kernel import lqt_combine_lanes as j_lanes
from repro.kernels.lqt_combine.ops import _to_lanes as j_to_lanes
from repro_torch.convert import elements_from_numpy
from repro_torch.core.combine import lqt_combine
from repro_torch.core.elements import identity_element
from repro_torch.core.pscan import prefix_scan, suffix_scan
from repro_torch.core.types import LQTElement
from repro_torch.kernels.lqt_combine import kernel as tkernel
from repro_torch.kernels.lqt_combine import ops as tops
from repro_torch.kernels.lqt_combine.ref import (
    lqt_combine_lanes_ref,
    lqt_combine_ref,
    lqt_scan_ref,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-9)


def _psd(rng, B, n):
    A = rng.standard_normal((B, n, n))
    return np.einsum("bij,bkj->bik", A, A) / n + 0.1 * np.eye(n)


def _rand_elems(rng, B, n):
    """Random elements with PSD C and J, as the reference's kernel tests
    build them (every Gauss-Jordan pivot >= 1)."""
    return (rng.standard_normal((B, n, n)) * 0.6, rng.standard_normal((B, n)),
            _psd(rng, B, n), rng.standard_normal((B, n)), _psd(rng, B, n))


def _assert_close(got, want, **tol):
    for g, w in zip(tuple(got), tuple(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


# The Pallas interpreter is slow eagerly; jitted, each shape compiles once.
_j_lanes = jax.jit(functools.partial(j_lanes, block_b=8, interpret=True))
_j_suffix = jax.jit(functools.partial(j_suffix, block_b=8, interpret=True))


@pytest.mark.parametrize("nx", [2, 4])
def test_combine_lanes_matches_pallas_interpret(nx):
    rng = np.random.default_rng(nx)
    e1, e2 = _rand_elems(rng, 8, nx), _rand_elems(rng, 8, nx)
    want = _j_lanes(j_to_lanes(JElem(*e1)), j_to_lanes(JElem(*e2)))
    t1 = tops._to_lanes(elements_from_numpy(e1))
    t2 = tops._to_lanes(elements_from_numpy(e2))
    before = tkernel.launch_count()
    got = tkernel.lqt_combine_lanes(tuple(a.contiguous() for a in t1),
                                    tuple(a.contiguous() for a in t2))
    _assert_close(got, want)
    _assert_close(tops._combine_lanes(t1, t2, block_size=128), want)
    assert tkernel.launch_count() == before       # CPU: plain version only


def test_kernel_suffix_scan_matches_pallas_interpret():
    """The main path's scan driver at an odd length (its tree has an empty
    level) against the reference's whole-scan kernel path."""
    rng = np.random.default_rng(105)
    arrs = _rand_elems(rng, 5, 4)
    je, te = JElem(*map(jnp.asarray, arrs)), elements_from_numpy(arrs)
    _assert_close(tops.kernel_suffix_scan(te), _j_suffix(je))


@pytest.mark.parametrize("T", [1, 2, 7, 16])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_scans_match_plain_scans(T, reverse):
    rng = np.random.default_rng(200 + T)
    te = elements_from_numpy(_rand_elems(rng, T, 3))
    scan = tops.kernel_suffix_scan if reverse else tops.kernel_prefix_scan
    _assert_close(scan(te), lqt_scan_ref(te, reverse=reverse))


def test_kernel_suffix_scan_carries_record_dims():
    """Records ride as lanes beside the scan axis: one scan over (n, R)
    equals R scans over n, on the same tree."""
    rng = np.random.default_rng(5)
    per = [elements_from_numpy(_rand_elems(rng, 9, 3)) for _ in range(3)]
    both = LQTElement(*(torch.stack(f, dim=1) for f in zip(*per)))
    got = tops.kernel_suffix_scan(both)
    for r, e in enumerate(per):
        want = suffix_scan(lqt_combine, e)
        _assert_close([a[:, r] for a in got], want, rtol=1e-12, atol=1e-12)


def test_precision_cast_round_trips_dtype():
    rng = np.random.default_rng(3)
    te = elements_from_numpy(_rand_elems(rng, 9, 3))
    got = tops.kernel_prefix_scan(te, precision="float32")
    want = prefix_scan(lqt_combine, te)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float64
    _assert_close(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="precision"):
        tops.kernel_prefix_scan(te, precision="bfloat16")


def test_combine_batched_and_empty_levels():
    rng = np.random.default_rng(9)
    e1 = elements_from_numpy(_rand_elems(rng, 6, 4))
    e2 = elements_from_numpy(_rand_elems(rng, 6, 4))
    _assert_close(tops.lqt_combine_batched(e1, e2), lqt_combine_ref(*e1, *e2),
                  rtol=1e-12, atol=1e-12)
    empty = LQTElement(*(a[:0] for a in e1))
    assert tops.lqt_combine_batched(empty, empty) is empty
    lanes = tuple(a[..., :0] for a in tops._to_lanes(e1))
    assert tops._combine_lanes(lanes, lanes, block_size=128) is lanes


def _lanes(rng, B, n, dtype=torch.float64):
    e = elements_from_numpy(_rand_elems(rng, B, n), dtype=dtype)
    return tuple(a.contiguous() for a in tops._to_lanes(e))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(0)
    ops1, ops2 = _lanes(rng, 5, 3), _lanes(rng, 5, 3)
    tkernel._check(ops1, ops2, 128)                   # valid input passes
    bad_cases = {
        "float32 or float64": (tuple(a.to(torch.float16) for a in ops1),
                               ops2, 128),
        "operand 5": (ops1, (ops2[0][..., :4].contiguous(),) + ops2[1:],
                      128),
        "not contiguous": (ops1, (ops2[0].transpose(0, 1),) + ops2[1:], 128),
        "block_size": (ops1, ops2, 100),
        "1 <= nx": (_lanes(rng, 5, 9), _lanes(rng, 5, 9), 128),
        "two 5-tuples": (ops1[:4], ops2, 128),
    }
    for match, (a, b, bs) in bad_cases.items():
        with pytest.raises((TypeError, ValueError), match=match):
            tkernel._check(a, b, bs)
    meta = tuple(a.to("meta") for a in ops1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.lqt_combine_lanes(meta, meta)


def test_no_build_at_import_and_ptxas_parse():
    assert tkernel.SOURCE.is_file()
    assert tkernel.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118lqt_"
        "combine_kernelILi4EdEEvPKT0_' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 0 bytes smem\n")
    assert tkernel._parse_ptxas(log) == [{
        "nx": 4, "dtype": "float64", "spill_stores": 8, "spill_loads": 12,
        "registers": 168}]


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-3)):
        ops1 = tuple(a.cuda() for a in _lanes(rng, 4097, 4, dtype))
        ops2 = tuple(a.cuda() for a in _lanes(rng, 4097, 4, dtype))
        before = tkernel.launch_count()
        got = tkernel.lqt_combine_lanes(ops1, ops2)
        want = lqt_combine_lanes_ref(ops1, ops2)
        torch.cuda.synchronize()
        assert tkernel.launch_count() == before + 1
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= tol * float(w.abs().max())


# ---------------------------------------------------------------------------
# The reference's hypothesis properties, on the plain version
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install -e '.[test]')")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _combine(e1, e2):
    return tops.lqt_combine_batched(e1, e2)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(1, 9))
def test_combine_associative(seed, n, B):
    """(e1 (x) e2) (x) e3 == e1 (x) (e2 (x) e3)."""
    rng = np.random.default_rng(seed)
    e1, e2, e3 = (elements_from_numpy(_rand_elems(rng, B, n))
                  for _ in range(3))
    _assert_close(_combine(_combine(e1, e2), e3),
                  _combine(e1, _combine(e2, e3)), rtol=1e-7, atol=1e-7)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(1, 12))
def test_zero_lanes_are_garbage_free(seed, n, B):
    """Zero lanes combine to exact zeros (M = I) and never perturb the
    real lanes."""
    rng = np.random.default_rng(seed)
    e1 = elements_from_numpy(_rand_elems(rng, B, n))
    e2 = elements_from_numpy(_rand_elems(rng, B, n))
    pad = (-(B + 3)) % 8 + 3
    ops1 = tuple(torch.nn.functional.pad(a, (0, pad))
                 for a in tops._to_lanes(e1))
    ops2 = tuple(torch.nn.functional.pad(a, (0, pad))
                 for a in tops._to_lanes(e2))
    out = tkernel.lqt_combine_lanes(ops1, ops2)
    want = lqt_combine_ref(*e1, *e2)
    for got_lane, w in zip(out, want):
        _assert_close([got_lane.movedim(-1, 0)[:B]], [w])
        assert not bool(got_lane[..., B:].any())


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 5), st.integers(1, 9))
def test_identity_element_is_two_sided_identity(seed, n, B):
    """combine(e, id) == combine(id, e) == e (eq. 34's zero-length
    interval)."""
    rng = np.random.default_rng(seed)
    e = elements_from_numpy(_rand_elems(rng, B, n))
    eid = LQTElement(*(a.expand((B,) + a.shape)
                       for a in identity_element(n, torch.float64)))
    for got in (_combine(e, eid), _combine(eid, e)):
        _assert_close(got, e)
