"""Operations and bytes of the parallel smoother, counted from shapes alone.

These are the yardstick's counts for ``solve_mfu.*`` and
``lqt_scan_roofline.*``: the work the paper's parallel RTS smoother
(sections 3-4, ``discrete`` element mode) needs for a wave, whatever
implements it.  One multiply-add is two operations; ``mm(a, b, c)`` is an
``a x b`` by ``b x c`` product, ``mv(a, b)`` an ``a x b`` matrix times a
vector, ``solve(n, k)`` an LU solve of ``n x n`` with ``k`` right-hand
sides.  The objective (Onsager-Machlup cost) that the program computes
beside the solve is not counted, nor is anything a particular
implementation repeats.
"""
from __future__ import annotations


def mm(a: int, b: int, c: int) -> int:
    return 2 * a * b * c


def mv(a: int, b: int) -> int:
    return 2 * a * b


def solve(n: int, k: int) -> float:
    return 2 * n ** 3 / 3 + mm(n, n, k)


def combine_flops(nx: int) -> int:
    """One eq.-(42) combine of LQT elements ``(A, b, C, eta, J)``, as the
    scan kernel computes it: nine matrix products, six matrix-vector
    products, a Gauss-Jordan inverse and the additions."""
    products = 9 * (2 * nx ** 3 - nx ** 2) + 6 * (2 * nx ** 2 - nx)
    gauss_jordan = nx * (1 + 2 * nx + (nx - 1) * 4 * nx)
    return products + gauss_jordan + nx + 2 * nx + 3 * nx + 2 * 3 * nx ** 2


def scan_bytes(n: int, rows: int, nx: int, itemsize: int) -> int:
    """One scan of ``n`` elements per row: each input element read once
    and each output element written once."""
    return 2 * n * rows * (3 * nx * nx + 2 * nx) * itemsize


def scan_combines(n: int) -> int:
    """Combines of the scan kernel's tree over ``n`` elements: ``L =
    floor(log2 n)`` down levels of ``n >> (l + 1)`` combines and ``L`` up
    levels of ``((n >> l) - 1) // 2``."""
    L = n.bit_length() - 1
    return (sum(n >> (l + 1) for l in range(L))
            + sum(((n >> l) - 1) // 2 for l in range(L)))


def element_flops(nx: int, ny: int) -> int:
    """One substep element: ``A = I + dt F~``, ``b = dt c~``, ``C = dt Q``,
    ``J = dt H^T R^-1 H``, ``eta = dt H^T R^-1 (y - r)``."""
    return (2 * nx * nx + nx + nx * nx
            + mm(nx, ny, ny) + mm(nx, ny, nx) + nx * nx
            + ny + mv(nx, ny) + nx)


def value_step_flops(nx: int) -> int:
    """One backward value step ``(S, v)`` through an element:
    ``S' = J + A^T S (I + C S)^-1 A``, ``v' = eta + A^T (I + S C)^-1
    (v - S b)``."""
    return (mm(nx, nx, nx) + nx + solve(nx, nx + 1) + 2 * mm(nx, nx, nx)
            + mv(nx, nx) + nx + mv(nx, nx) + nx + nx * nx)


def recovery_map_flops(nx: int) -> float:
    """The affine map of one substep: ``(I + C S)^-1 (A phi + b + C v)``."""
    return mm(nx, nx, nx) + nx + mv(nx, nx) + nx + solve(nx, nx + 1)


def affine_combine_flops(nx: int) -> int:
    return mm(nx, nx, nx) + mv(nx, nx) + nx


def linearisation_flops(nx: int, ny: int) -> int:
    """A lower bound for one point's Taylor linearisation: one operation
    per Jacobian entry, then ``c = f - F x`` and ``r = h - H x``."""
    return nx * nx + ny * nx + mv(nx, nx) + nx + mv(ny, nx) + ny


def record_flops(intervals: int, nsub: int, nx: int, ny: int,
                 passes: int = 1, linearised: bool = False) -> float:
    """One record of ``intervals`` substeps, in blocks of ``nsub`` (the
    last one short where ``nsub`` does not divide the length): per pass
    the substep elements, their composition into blocks, the scan over
    ``blocks + 1`` elements, the value fill inside blocks and the
    trajectory's recovery (maps, in-block composition, a prefix scan of
    ``blocks`` maps, application); with ``linearised`` also the Taylor
    linearisation of every point.  Padding is not work of the record."""
    N = intervals
    blocks = -(-N // nsub)
    per_pass = (N * (element_flops(nx, ny) + value_step_flops(nx)
                     + recovery_map_flops(nx) + mv(nx, nx) + nx)
                + (N - blocks) * (combine_flops(nx)
                                  + affine_combine_flops(nx))
                + scan_combines(blocks + 1) * combine_flops(nx)
                + 2 * blocks * affine_combine_flops(nx))
    if linearised:
        per_pass += N * linearisation_flops(nx, ny)
    return passes * per_pass


def solve_flops(blocks: int, nsub: int, rows: int, nx: int, ny: int,
                passes: int = 1, linearised: bool = False) -> float:
    """One stacked solve of ``rows`` records of ``blocks * nsub``
    substeps each (:func:`record_flops` of each row)."""
    return rows * record_flops(blocks * nsub, nsub, nx, ny, passes,
                               linearised)
