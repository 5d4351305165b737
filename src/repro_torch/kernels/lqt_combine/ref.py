"""Plain PyTorch versions of the batched LQT combination (paper eq. 42).

The same math as :func:`repro_torch.core.combine.lqt_combine` (pivoted
``torch.linalg.solve``), exposed in the kernels' calling conventions.  The
CUDA wrappers (:func:`.kernel.lqt_combine_lanes`, :func:`.scan.lqt_scan`)
run :func:`lqt_combine_lanes_ref` / :func:`lqt_scan_ref` for tensors that
lie on the CPU, and the card checks compare the kernels with them.
"""
from __future__ import annotations

from repro_torch.core.combine import lqt_combine as _core_combine
from repro_torch.core.pscan import prefix_scan, suffix_scan
from repro_torch.core.types import LQTElement


def lqt_combine_ref(A1, b1, C1, eta1, J1, A2, b2, C2, eta2, J2):
    """Eq. (42) on natural-layout ``(..., nx, nx)``/``(..., nx)`` operands."""
    out = _core_combine(
        LQTElement(A1, b1, C1, eta1, J1), LQTElement(A2, b2, C2, eta2, J2))
    return tuple(out)


def lqt_combine_lanes_ref(ops1, ops2):
    """Eq. (42) on lane-major 5-tuples: matrices ``(nx, nx, B)``, vectors
    ``(nx, B)``; returns contiguous lane-major outputs."""
    def natural(ops):
        A, b, C, eta, J = ops
        return (A.permute(2, 0, 1), b.T, C.permute(2, 0, 1), eta.T,
                J.permute(2, 0, 1))

    A, b, C, eta, J = lqt_combine_ref(*natural(ops1), *natural(ops2))
    return tuple(x.contiguous() for x in (
        A.permute(1, 2, 0), b.T, C.permute(1, 2, 0), eta.T, J.permute(1, 2, 0)))


def lqt_scan_ref(elems: LQTElement, *, reverse: bool = False) -> LQTElement:
    """Plain inclusive scan along axis 0 (earlier operand first; with
    ``reverse`` the suffix scan ``out[i] = a_i (x) ... (x) a_{n-1}``): the
    core associative scan with the core combine, in the natural layout.
    Its tree is the scan kernel's (``csrc/lqt_scan.cu``), combine for
    combine."""
    scan = suffix_scan if reverse else prefix_scan
    return scan(_core_combine, elems)
