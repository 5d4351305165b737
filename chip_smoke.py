#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any miss:

1. build      -- compile the six CUDA kernel libraries from the sources
                 in this checkout (one ``nvcc`` per source, all at once,
                 for ``sm_90a`` into ``build/``): ``lqt_combine`` (pairwise),
                 ``lqt_scan`` (a whole scan in one launch), and two
                 variants each of ``flash_attention`` and ``ssd_chunked``
                 (``mma``: bf16 tensor cores; ``simt``: float32 CUDA
                 cores), with ptxas's register and spill counts per
                 instantiation and the HMMA/HGMMA count of each ``mma``
                 library's SASS (``cuobjdump``);
2. kernels    -- each kernel against its plain PyTorch version on the
                 card: ``lqt_combine`` on random element pairs with PSD
                 C/J, nx in {2, 4, 5, 8}, lane counts {1, 7, 4097, 2**20},
                 float32 and float64; the scan kernel against the plain
                 scan at every nx in 1..8 (n in {1, 2, 17, 513, 2049}
                 at the paths' nx = 4, 5; n in {1, 2, 17, 513} at the
                 others), records {1, 64}, float32 and float64, both
                 directions, and
                 ``kernel_suffix_scan`` against the core suffix scan;
                 ``flash_attention`` and
                 ``ssd_chunked`` in float32 and bfloat16 on the reference's
                 small test cases and at hymba-1.5b's prefill shapes, plus
                 bfloat16 cases for the tensor-core tiling, each case
                 naming the variant it ran; the SSD ``mma`` kernel's
                 stage-2 chunk states against the staged plain version;
3. estimation -- ``Estimator(method="parallel_kernel").solve`` on the
                 Wiener velocity model (paper section 5.1) at T = 2048
                 blocks x nsub = 10 (N = 20480) in float64, for one record
                 and for 64 stacked records, held against the port's
                 ``parallel_rts`` on the card and its ``sequential_rts`` on
                 the CPU, with the launch count of the scan kernel (one
                 per solve's backward scan), the median solve time and one
                 profiled solve per cell;
3b. nonlinear -- the paper's Fig.-2 experiment: the iterated Taylor
                 smoother (5 passes) on the coordinated-turn model
                 (section 5.2) at T = 512 blocks x nsub = 10 (N = 5120) in
                 ``mode="euler"``, float64, one record and 64 stacked
                 records from the port's ``simulate_nonlinear``:
                 ``parallel_kernel`` (the scan kernel at nx = 5, one launch
                 per pass) against
                 ``parallel_rts`` and ``sequential_rts`` on the card, the
                 two-filter smoother (``discrete``) against ``parallel_rts``
                 (``discrete``), the cost traces, median solve times of the
                 three methods, one profiled solve per cell, and the solve in
                 float32 (its distance from float64 printed, not gated);
3c. sigma point -- ``method="sigma_point"`` (the posterior-linearisation
                 smoother, section 5.2's model) on the nonlinear phase's
                 records: unscented SLR on one record and on 64, cubature
                 on one, 5 passes each with the scan kernel as the inner
                 method (one launch per pass), against the same options
                 with ``parallel_rts`` on the card, the cost traces beside
                 the Taylor IEKS's costs, median solve times and one
                 profiled solve per cell;
3d. ragged    -- 64 Wiener records of 2560..20480 intervals (seeded
                 draws, prefixes of the estimation phase's records) as one
                 ``Problem.ragged`` through ``parallel_kernel``: one stacked
                 solve and one scan launch per bucket, the padding report
                 against the lengths, every record against ``parallel_rts``
                 on the card and each bucket's shortest record, unpadded,
                 against ``sequential_rts`` on the CPU, the median solve
                 time and one profile;
3e. trajectory engine -- the ragged cell's 64 records submitted from the
                 host in draw order to ``TrajectoryEngine(batch=16,
                 method="parallel_kernel")`` and drained: waves per bucket
                 (ceil(records / 16)), one scan launch per wave, the
                 recycled rows, every record against the port's
                 ``parallel_rts`` ragged solve on the card; drain
                 records/s, record latency p50/p99, occupancy, padding
                 waste (``repro_torch.obs``) and one profiled wave;
3f. streaming, linear -- 256 Wiener tracks of 400 intervals through
                 ``StreamingEngine(lag=64, batch=64,
                 method="parallel_kernel")`` in round-robin chunks of 20
                 with a drain after each round (the reference's streaming
                 benchmark workload at 16x its tracks), after a warm-up
                 pass on other tracks: one scan launch per wave, four
                 tracks' final windows against an offline ``parallel_rts``
                 solve of the whole record; windows/s, window latency
                 p50/p99, eviction counters and one profiled wave; then a
                 late pass (lag 10, reorder slack 20, 10 % of the
                 measurements one round late): no late drops and the same
                 offline bound;
3g. streaming, sigma point -- 64 coordinated-turn tracks of 200
                 intervals through two ``StreamingEngine(method=
                 "sigma_point")``s (inner ``parallel_kernel`` and
                 ``parallel_rts``) on the same pushes: the scan launched
                 once per pass of each wave, the final estimates within
                 1e-8 of each other; windows/s and latency;
3h. lqt timing -- the scan kernel at every path's scans
                 (CUDA events around a CUDA-graph replay of back-to-back
                 scans, eager calls beside), its bound, the per-launch bound
                 of the tree's combines it replaces, the plain scan, and a
                 depth sweep over one record (its slope is the latency per
                 tree level); the pairwise kernel at the launch shapes the
                 per-level scan had (graph replay, eager calls, profiler),
                 beside its plain version and bound;
4. serving    -- ``ServeEngine.generate`` on hymba-1.5b at full width in
                 bfloat16 (random weights from a seeded generator): 16
                 requests of 2048 prompt tokens and 32 new tokens in two
                 waves of 8, with the launch counts of both LM kernels
                 (32 each per wave, all of the ``mma`` variant), prefill
                 ms per wave, decode ms per
                 step and tokens/s from CUDA events, and one profiled
                 prefill and decode step;
5. cross-path -- the same weights in float32, one wave of 8 x 2048
                 tokens: prefill logits of the kernel path against the
                 plain path, and their first generated tokens;
6. LM kernels -- each LM kernel's time at the serving path's shapes,
                 beside the simt design at the same shape (timed in turns),
                 its plain version, the PyTorch library call where there
                 is one, its bound, and each SSD stage's time;
7. report     -- one JSON line of per-kernel numbers, the card's name and
                 power limit, and the final status line.

It needs a CUDA card: without one it exits non-zero and prints no result.
It imports only the port, never the JAX reference package.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, the non-tensor-core
# float rates, and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12,
              torch.bfloat16: 989e12}

N_BLOCKS, NSUB, RECORDS = 2048, 10, 64
SEED = 0
# coordinated-turn cell: the top of the reference's Fig.-2 harness
# (benchmarks/fig2_nonlinear.py:19), 5 passes in euler mode
NL_BLOCKS, NL_ITERS, NL_MODE = 512, 5, "euler"
# nonlinear gates: kernel vs plain combine on the same arithmetic up to the
# combine's pivoting; euler-mode parallel vs sequential and two-filter vs
# RTS at the reference's own bounds (tests/test_nonlinear.py:
# test_euler_mode_ieks, test_two_filter_ieks)
NL_KERNEL_TOL, NL_SEQ_TOL, NL_TF_TOL = 1e-8, 5e-2, 1e-5
# ragged cell: record lengths drawn uniformly from these interval counts
# (256 to 2048 blocks of nsub = 10), mostly not multiples of nsub
RAGGED_LENGTHS = (2560, 20480)
# trajectory-engine cell: the ragged cell's records through the engine in
# waves of ENGINE_BATCH
ENGINE_BATCH = 16
# streaming cells: the reference's streaming benchmark workload (lag 64,
# chunks of 20; benchmarks/streaming_latency.py:136) at 256 tracks of 400
# intervals in waves of 64; sigma point: 64 tracks of 200 intervals
STREAM_TRACKS, STREAM_N, STREAM_LAG, STREAM_CHUNK, STREAM_BATCH = (
    256, 400, 64, 20, 64)
SP_STREAM_TRACKS, SP_STREAM_N = 64, 200
# kernel vs plain version: normwise relative error bound per dtype.  The
# unpivoted Gauss-Jordan and the pivoted solve differ by round-off times
# the conditioning of M = I + C1 J2 (at most a few hundred for these
# operands), so float64 stays far below 1e-10 and float32 below 1e-3.
KERNEL_RTOL = {torch.float64: 1e-10, torch.float32: 1e-3}
# scan kernel vs plain scan, normwise: the same tree and combine order, each
# combine differing by the combine's round-off (above), compounded over the
# tree's levels
SCAN_RTOL = {torch.float64: 1e-9, torch.float32: 1e-3}
SCAN_SWEEP = (2, 3, 5, 9, 17, 33, 65, 129, 257, 513, 1025, 2049)
# scan check sizes: the paths' state sizes (nx = 4, 5) up to their longest
# scan; the rest of 1 <= nx <= 8 (no path runs them) at fewer sizes
PATH_NX = (4, 5)
SCAN_CHECK_N = {True: (1, 2, 17, N_BLOCKS // 4 + 1, N_BLOCKS + 1),
                False: (1, 2, 17, N_BLOCKS // 4 + 1)}

# hymba-1.5b serving cell: two waves of 8 prompts of 2048 tokens.  2048 is
# a multiple of the 1024 window, the 256 SSD chunk and chunked_mha's 512
# chunk, so the rolling cache is placed as decode expects.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW, LM_REQUESTS = (
    "hymba-1.5b", 8, 2048, 32, 16)
LM_MAX_LEN = LM_PROMPT + LM_NEW
# LM kernels vs plain versions, from the reference's own test tolerances
# (tests/test_kernels.py): attention allclose at 2e-5 (float32) / 2e-2
# (bfloat16); SSD max abs error within 2e-5 (float32) / 0.04 (bfloat16)
# of the output's magnitude.  The SSD rule is normwise because each output
# sums up to Q * S products (256 * 128 at the largest case) of terms much
# larger than the smallest outputs, in another order than the plain
# version: float32 round-off scales with those terms, not elementwise.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 2e-5, torch.bfloat16: 0.04}
# kernel path vs plain path on the whole model, float32: the two differ
# by float32 sums in another order through 32 layers.
CROSS_RTOL = 1e-3
# name fragments of the port's kernels in a profiler trace
PORT_KERNELS = ("flash_attn", "ssd_", "lqt_combine", "lqt_scan")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    torch.cuda.synchronize()
    log(f"== {name}")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    global _CARD
    if _CARD is None:
        _CARD = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return _CARD


_CARD = None


def random_pairs(nx, B, dtype, g):
    """Lane-major operand 5-tuples ``(nx, nx, B)``/``(nx, B)`` with PSD
    C and J (every Gauss-Jordan pivot >= 1)."""
    dev = "cuda"

    def r(*s):
        return torch.randn(*s, generator=g, device=dev, dtype=torch.float64)

    def psd():
        A = r(B, nx, nx)
        return (A @ A.transpose(-1, -2) / nx
                + 0.1 * torch.eye(nx, device=dev, dtype=torch.float64))

    def side():
        A, b, C, e, J = r(B, nx, nx) * 0.6, r(B, nx), psd(), r(B, nx), psd()
        return tuple(x.to(dtype).contiguous() for x in (
            A.permute(1, 2, 0), b.T, C.permute(1, 2, 0), e.T,
            J.permute(1, 2, 0)))

    return side(), side()


def random_elems(n, R, nx, dtype, g):
    """Natural-layout elements ``(n, nx, nx)`` (R = 1) or ``(n, R, nx, nx)``
    with PSD C and J."""
    sh = (n,) if R == 1 else (n, R)

    def r(*s):
        return torch.randn(*s, generator=g, device="cuda", dtype=torch.float64)

    def psd():
        A = r(*sh, nx, nx)
        return (A @ A.transpose(-1, -2) / nx
                + 0.1 * torch.eye(nx, device="cuda", dtype=torch.float64))

    from repro_torch.core.types import LQTElement
    return LQTElement(*(x.to(dtype) for x in (
        r(*sh, nx, nx) * 0.6, r(*sh, nx), psd(), r(*sh, nx), psd())))


def compare(got, want):
    """(max abs error, normwise relative error) over the output tuple."""
    abs_err = max(float((a.double() - b.double()).abs().max()) for a, b in
                  zip(got, want))
    scale = max(float(b.double().abs().max()) for b in want)
    return abs_err, abs_err / max(scale, 1e-300)


def combine_flops(nx: int) -> int:
    """Floating-point operations of one eq.-(42) combine in the kernel."""
    mm, mv = 2 * nx ** 3 - nx ** 2, 2 * nx ** 2 - nx
    gauss_jordan = nx * (1 + 2 * nx + (nx - 1) * 4 * nx)
    return (9 * mm + 6 * mv + gauss_jordan
            + nx + 2 * nx + 3 * nx + 2 * 3 * nx ** 2)


def combine_bytes(nx: int, itemsize: int) -> int:
    """Each input read once, each output written once, per pair."""
    values = 2 * (3 * nx * nx + 2 * nx) + (3 * nx * nx + 2 * nx)
    return values * itemsize


def scan_bytes(n: int, R: int, nx: int, itemsize: int) -> int:
    """A whole scan: each input element read once, each output written
    once."""
    return 2 * n * R * (3 * nx * nx + 2 * nx) * itemsize


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back runs, by CUDA
    events around one replay of a CUDA graph that holds the ``reps`` runs:
    the launches follow each other without the host's per-call cost, so
    this is the card's time even where one call's host work outlasts its
    kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def scan_time_ms(fn, reps: int) -> tuple:
    """``(ms, method)``: the graph-replay time of ``fn`` where a CUDA graph
    can capture it (``"graph"``), else CUDA events around back-to-back eager
    calls (``"eager"``, host launch cost included), with a line saying why."""
    try:
        return graph_time_ms(fn, reps), "graph"
    except Exception as exc:               # capture refused on this CUDA
        torch.cuda.synchronize()
        log(f"  CUDA-graph capture refused ({type(exc).__name__}: "
            f"{str(exc)[:120]}); timing eager calls")
        return cuda_time_ms(fn, reps), "eager"


def device_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs: the summed self
    time of the CUDA kernels it ran, from ``torch.profiler``.  Where the
    profiler records no device time, the CUDA-event time of the same runs
    stands in (it includes host launch overhead) and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if total <= 0:
        log("  torch.profiler recorded no device time; using CUDA events")
        return cuda_time_ms(fn, reps)
    return total / 1e3 / reps


def kernel_name(key: str) -> str:
    """A port kernel's name (with template arguments) in a trace key."""
    m = re.search(r"\w*(?:%s)\w*(?:<[^>]*>)?" % "|".join(PORT_KERNELS), key)
    return m.group(0) if m else key[:60]


def profile_summary(label: str, fn, wall_ms: float) -> None:
    """One profiled call: device kernels, busy time against ``wall_ms``
    (the call's CUDA-event time without the profiler), top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    count = sum(e.count for e in kern)
    log(f"  {label}: {count} device kernels, device busy {busy:.3f} ms of "
        f"a {wall_ms:.3f} ms call (idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
            f"x{e.count:<5d} {e.key[:90]}")
    ours = [e for e in kern if any(n in e.key for n in PORT_KERNELS)]
    if ours:
        t = sum(e.self_device_time_total for e in ours) / 1e3
        log(f"    the port's kernels: {t:.3f} ms ({t / busy:.3f} of busy): "
            + ", ".join(f"{kernel_name(e.key)} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.3f} ms"
                        for e in ours))


def scan_lane_counts(n: int, records: int) -> list:
    """Lane count of every combine the kernel scan launches for ``n`` scan
    elements of ``records`` records (the same tree the kernel scan in ``ops.py`` runs)."""
    from repro_torch.core.pscan import associative_scan

    counts = []

    def fn(a, b):
        counts.append(a[0].shape[-1] * records)
        return a

    associative_scan(fn, (torch.zeros(n),), axis=-1)
    return counts


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(bound ms, "bytes" or "operations") on an H100 SXM."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump``, or None."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/nonexistent") / "bin" / "cuobjdump"
    return str(tool) if tool.exists() else shutil.which("cuobjdump")


def tensor_core_counts(library: str) -> dict | None:
    """``HMMA``/``HGMMA`` instructions in a library's SASS, or None without
    ``cuobjdump``."""
    tool = cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA")}


def build_all(jobs: dict) -> None:
    """One ``nvcc`` per source, all started together.  ``jobs`` maps a
    label to a function that builds one library; labels ending in ``mma``
    are the tensor-core kernels, whose SASS must hold HMMA or HGMMA."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(fn) for name, fn in jobs.items()}
        infos = {name: f.result() for name, f in futures.items()}
    log(f"built {len(infos)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, info in infos.items():
        log(f"{name}: built in {info['seconds']:.1f} s "
            f"(cached={info['cached']}) -> {info['library']}")
        if not info["ptxas"]:
            raise AssertionError(f"{name}: ptxas reported no kernel")
        for row in info["ptxas"]:
            inst = " ".join(f"{k}={v}" for k, v in row.items()
                            if k not in ("registers", "spill_stores",
                                         "spill_loads"))
            log(f"  ptxas {name} {inst}: {row.get('registers')} registers, "
                f"{row.get('spill_stores')} B spill stores, "
                f"{row.get('spill_loads')} B spill loads")
        if name.endswith("mma"):
            counts = tensor_core_counts(info["library"])
            if counts is None:
                log(f"  {name}: no cuobjdump in this toolkit; the source "
                    f"issues mma.sync.m16n8k16 (ptxas compiled it above)")
            else:
                log(f"  {name} SASS: {counts['HMMA']} HMMA, "
                    f"{counts['HGMMA']} HGMMA instructions")
                if counts["HMMA"] + counts["HGMMA"] == 0:
                    raise AssertionError(f"{name}: no tensor-core "
                                         f"instruction in the SASS")


# ---------------------------------------------------------------------------
# 2. kernels vs plain versions
# ---------------------------------------------------------------------------

def check_lqt(g, lqt_kernel, lqt_ref) -> None:
    from repro_torch.core import suffix_scan
    from repro_torch.core.combine import lqt_combine
    from repro_torch.core.types import LQTElement
    from repro_torch.kernels.lqt_combine.ops import kernel_suffix_scan

    for dtype in (torch.float32, torch.float64):
        for nx in (2, 4, 5, 8):
            for B in (1, 7, 4097, 2 ** 20):
                ops1, ops2 = random_pairs(nx, B, dtype, g)
                got = lqt_kernel.lqt_combine_lanes(ops1, ops2)
                want = lqt_ref.lqt_combine_lanes_ref(ops1, ops2)
                torch.cuda.synchronize()
                abs_err, rel_err = compare(got, want)
                ok = rel_err < KERNEL_RTOL[dtype]
                log(f"  lqt_combine {str(dtype)[6:]} nx={nx} B={B}: "
                    f"max abs err {abs_err:.3e}, normwise rel err "
                    f"{rel_err:.3e} (tol {KERNEL_RTOL[dtype]:.0e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"lqt_combine kernel disagrees with its plain "
                        f"version: {dtype} nx={nx} B={B}")
                del ops1, ops2, got, want
    torch.cuda.empty_cache()

    n_elems = N_BLOCKS + 1
    e = random_pairs(4, n_elems, torch.float64, g)[0]
    elems = LQTElement(e[0].permute(2, 0, 1), e[1].T, e[2].permute(2, 0, 1),
                       e[3].T, e[4].permute(2, 0, 1))
    got = kernel_suffix_scan(elems)
    want = suffix_scan(lqt_combine, elems)
    torch.cuda.synchronize()
    abs_err, rel_err = compare(got, want)
    log(f"  kernel_suffix_scan vs plain suffix_scan, {n_elems} elements "
        f"nx=4 float64: max abs err {abs_err:.3e}, normwise rel err "
        f"{rel_err:.3e} (tol 1e-9)")
    if not rel_err < 1e-9:
        raise AssertionError("kernel_suffix_scan disagrees with suffix_scan")


def check_scan(g, lqt_scan, lqt_ref) -> None:
    """The scan kernel against the plain scan (the same tree in the kernel's
    schedule, pivoted solves), one launch per call."""
    for dtype in (torch.float64, torch.float32):
        for nx in range(1, 9):
            for n in SCAN_CHECK_N[nx in PATH_NX]:
                worst, cases = 0.0, 0
                for R in (1, RECORDS):
                    for rev in (False, True):
                        e = random_elems(n, R, nx, dtype, g)
                        before = lqt_scan.launch_count()
                        got = lqt_scan.lqt_scan(e, reverse=rev)
                        launched = lqt_scan.launch_count() - before
                        want = lqt_ref.lqt_scan_ref(e, reverse=rev)
                        torch.cuda.synchronize()
                        _, rel = compare(got, want)
                        finite = all(bool(torch.isfinite(x).all())
                                     for x in got)
                        if not (launched == 1 and finite
                                and rel < SCAN_RTOL[dtype]):
                            raise AssertionError(
                                f"lqt_scan {dtype} nx={nx} n={n} R={R} "
                                f"rev={rev}: {launched} launches, normwise "
                                f"rel err {rel:.3e}, finite {finite}")
                        worst, cases = max(worst, rel), cases + 1
                        del e, got, want
                log(f"  lqt_scan {str(dtype)[6:]} nx={nx} n={n}: {cases} cases"
                    f" (records 1 and {RECORDS}, both directions), one launch "
                    f"each, worst normwise rel err {worst:.3e} (tol "
                    f"{SCAN_RTOL[dtype]:.0e}) ok")
    torch.cuda.empty_cache()


# (B, Hq, Hkv, Lq, Lk, D, causal, window): the reference's five test cases,
# two ragged-edge cases, and hymba-1.5b's prefill, in both dtypes; then
# bfloat16 cases for the tensor-core kernel's tiling: D in {16, 32, 128},
# Lq < Lk (decode alignment), Lq and Lk off the 64-row tiles, windows off
# the tiles, and no causal mask.
FA_CASES = [
    (2, 4, 2, 64, 64, 16, True, None),
    (1, 6, 2, 32, 32, 32, True, 24),
    (2, 4, 4, 16, 64, 16, True, None),
    (1, 2, 1, 64, 64, 8, False, None),
    (1, 8, 1, 128, 128, 16, True, 32),
    (1, 4, 2, 100, 300, 128, True, None),
    (1, 4, 2, 200, 200, 64, True, 70),
    (8, 25, 5, 2048, 2048, 64, True, 1024),
]
FA_MMA_CASES = [
    (2, 4, 2, 128, 128, 16, True, None),
    (1, 6, 2, 96, 160, 32, True, 40),
    (2, 8, 2, 100, 300, 128, True, 70),
    (1, 4, 1, 1, 300, 64, True, None),
    (3, 4, 2, 7, 1000, 64, True, 130),
    (1, 25, 5, 200, 200, 64, True, 100),
    (1, 4, 2, 80, 130, 32, False, None),
    (1, 4, 2, 64, 200, 128, False, 50),
]
# (BH, L, P, S, chunk): the reference's four test shapes (heads folded in),
# two more, and hymba-1.5b's prefill (8 x 50 heads), in both dtypes; then
# bfloat16 cases for the chunk-parallel kernel's tiling: S in {8, 64, 128},
# P in {16, 128}, chunks of 64, 100 and 256.
SSD_CASES = [
    (8, 64, 16, 8, 16),
    (6, 48, 32, 16, 16),
    (4, 40, 8, 4, 8),
    (2, 128, 64, 64, 64),
    (4, 512, 128, 128, 256),
    (3, 300, 64, 16, 100),
    (400, 2048, 64, 16, 256),
]
SSD_MMA_CASES = [
    (4, 512, 16, 8, 256),
    (3, 300, 128, 64, 100),
    (2, 256, 128, 128, 64),
    (5, 200, 16, 128, 100),
    (6, 768, 128, 8, 256),
    (3, 512, 16, 64, 64),
]
# stage-2 chunk states of the tensor-core SSD kernel against the staged
# plain version, max abs error over max |state|: float32 scans of states
# whose increments carry the 2^-16 hi/lo split of exp(total - cum) dtx.
SSD_STATE_TOL = 1e-4


def fa_inputs(case, dtype, g):
    B, Hq, Hkv, Lq, Lk, D, _, _ = case
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))


def ssd_inputs(case, dtype, g):
    BH, L, P, S, _ = case
    l = -torch.rand(BH, L, generator=g, device="cuda") * 0.2
    return (l,) + tuple(
        torch.randn(s, generator=g, device="cuda").to(dtype)
        for s in ((BH, L, P), (BH, L, S), (BH, L, S)))


def launched(kernel, call) -> tuple:
    """``(result, variant)``: ``call()``'s result and the one variant whose
    launch count it moved (it must move exactly one, by one)."""
    before = {v: kernel.launch_count(v) for v in kernel.VARIANTS}
    out = call()
    moved = [v for v in kernel.VARIANTS
             if kernel.launch_count(v) != before[v]]
    if len(moved) != 1 or kernel.launch_count(moved[0]) != (
            before[moved[0]] + 1):
        after = {v: kernel.launch_count(v) for v in before}
        raise AssertionError(f"{kernel.__name__}: one call moved the "
                             f"launch counts {before} -> {after}")
    return out, moved[0]


def check_fa(g, fa_kernel, fa_ref) -> float:
    """Returns the max abs error at hymba's prefill shape in bfloat16."""
    err_main = None
    cases = ([(dtype, c) for dtype in (torch.float32, torch.bfloat16)
              for c in FA_CASES]
             + [(torch.bfloat16, c) for c in FA_MMA_CASES])
    for dtype, case in cases:
        causal, window = case[6], case[7]
        q, k, v = fa_inputs(case, dtype, g)
        got, which = launched(fa_kernel, lambda: fa_kernel.flash_attention(
            q, k, v, causal=causal, window=window))
        if which != fa_kernel.variant(dtype, case[5]):
            raise AssertionError(f"flash_attention {dtype} {case} ran "
                                 f"{which}, the rule names "
                                 f"{fa_kernel.variant(dtype, case[5])}")
        want = fa_ref.mha_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FA_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        rel = err / max(float(want.float().abs().max()), 1e-30)
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        log(f"  flash_attention {which} {str(dtype)[6:]} {case}: max abs err "
            f"{err:.3e}, rel {rel:.3e} (allclose rtol=atol={tol:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention kernel disagrees with "
                                 f"its plain version: {dtype} {case}")
        if case == FA_CASES[-1] and dtype == torch.bfloat16:
            err_main = err
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return err_main


def check_ssd(g, ssd_kernel, ssd_ref) -> float:
    """Returns the max abs error at hymba's prefill shape in bfloat16."""
    err_main = None
    cases = ([(dtype, c) for dtype in (torch.float32, torch.bfloat16)
              for c in SSD_CASES]
             + [(torch.bfloat16, c) for c in SSD_MMA_CASES])
    for dtype, case in cases:
        chunk = case[-1]
        ins = ssd_inputs(case, dtype, g)
        got, which = launched(ssd_kernel, lambda: ssd_kernel.ssd_chunked(
            *ins, chunk=chunk))
        if which != ssd_kernel.variant(dtype, case[2]):
            raise AssertionError(f"ssd_chunked {dtype} {case} ran {which}, "
                                 f"the rule names "
                                 f"{ssd_kernel.variant(dtype, case[2])}")
        want = ssd_ref.ssd_chunked_ref(*ins, chunk=chunk)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = max(float(want.float().abs().max()), 1e-30)
        ok = err <= SSD_TOL[dtype] * scale
        rule = f"abs <= {SSD_TOL[dtype]:.0e} max|want|"
        states = ""
        if which == "mma":
            # the entering chunk states of stage 2, against the staged plain
            # version: a fault shows at its stage
            _, st, _ = ssd_kernel._run_mma(*ins, chunk)
            _, want_st = ssd_ref.ssd_staged_ref(*ins, chunk=chunk)
            st_err = float((st - want_st).abs().max()) / max(
                float(want_st.abs().max()), 1e-30)
            ok = ok and st_err <= SSD_STATE_TOL
            states = (f"; stage-2 states rel err {st_err:.3e} (tol "
                      f"{SSD_STATE_TOL:.0e})")
            del st, want_st
        log(f"  ssd_chunked {which} {str(dtype)[6:]} {case}: max abs err "
            f"{err:.3e}, rel {err / scale:.3e} ({rule}){states} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ssd kernel disagrees with its plain "
                                 f"version: {dtype} {case}")
        if case == SSD_CASES[-1] and dtype == torch.bfloat16:
            err_main = err
        del ins, got, want
        torch.cuda.empty_cache()
    return err_main


# ---------------------------------------------------------------------------
# 3. estimation path
# ---------------------------------------------------------------------------

def median_solve_ms(est, problem, runs: int = 5) -> float:
    """Median of ``runs`` solves by CUDA events, after one warm-up."""
    est.solve(problem)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        est.solve(problem)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def estimation_path(lqt_kernel, lqt_scan) -> tuple:
    """Returns the scan kernel's launch count and scans (elements, records)
    on the path, and the launch shapes the per-level scan had; and the
    cell (model, time grid, the 64 records' measurements)."""
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
        simulate_linear,
        time_grid,
    )

    cfg = WienerVelocityConfig()
    model = cfg.model(dtype=torch.float64, device="cuda")
    N = N_BLOCKS * NSUB
    ts = time_grid(cfg.t0, cfg.tf, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    _, y1 = simulate_linear(model, ts, gm)                       # (N, ny)
    _, yb = simulate_linear(model, ts[:, None].expand(-1, RECORDS), gm)
    problems = {"single": Problem.single(model, ts, y1),
                "stacked64": Problem.stacked(model, ts, yb.movedim(1, 0))}
    torch.cuda.synchronize()
    log(f"Wiener velocity, T={N_BLOCKS} blocks x nsub={NSUB} (N={N}), "
        f"float64, records: single and {RECORDS} stacked")

    kopts = KernelOptions(nsub=NSUB, mode="discrete")
    est_k = Estimator(model, method="parallel_kernel", options=kopts)
    est_p = Estimator(model, method="parallel_rts",
                      options=ParallelOptions(nsub=NSUB, mode="discrete"))
    est_s = Estimator(model, method="sequential_rts",
                      options=SequentialOptions(mode="discrete"),
                      device="cpu")

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols = {k: est_k.solve(p) for k, p in problems.items()}
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    log(f"main path launches: lqt_scan {launches} (one per backward scan), "
        f"lqt_combine {lqt_kernel.launch_count()}")
    if launches != len(problems) or lqt_kernel.launch_count():
        raise AssertionError(f"expected {len(problems)} lqt_scan launches "
                             f"and no lqt_combine launch on the main path, "
                             f"counted {launches} and "
                             f"{lqt_kernel.launch_count()}")

    for name, p in problems.items():
        sol = sols[name]
        for f in ("x", "S", "v", "cost"):
            t = getattr(sol, f)
            if t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: {f} not finite on cuda")
        want_shape = ((N + 1, 4) if name == "single"
                      else (RECORDS, N + 1, 4))
        if tuple(sol.x.shape) != want_shape:
            raise AssertionError(f"{name}: x shape {tuple(sol.x.shape)}")
        refs = {"parallel_rts (cuda)": est_p.solve(p),
                "sequential_rts (cpu reference)": est_s.solve(p)}
        for ref_name, ref in refs.items():
            dx = float((sol.x.cpu() - ref.x.cpu()).abs().max())
            ok = dx < 1e-8
            for f in ("S", "v"):
                a, b = getattr(sol, f).cpu(), getattr(ref, f).cpu()
                ok = ok and torch.allclose(a, b, rtol=1e-9, atol=1e-8)
            log(f"  {name}: parallel_kernel vs {ref_name}: max|dx| "
                f"{dx:.3e} (tol 1e-8), S/v within rtol 1e-9 atol 1e-8: "
                f"{ok}")
            if not ok:
                raise AssertionError(f"{name}: parallel_kernel disagrees "
                                     f"with {ref_name}")

    solve_ms = {}
    for name, p in problems.items():
        for label, est in (("parallel_kernel", est_k),
                           ("parallel_rts", est_p)):
            solve_ms[(name, label)] = median_solve_ms(est, p)
            log(f"  solve {name} {label}: median {solve_ms[(name, label)]:.3f}"
                f" ms over 5 runs (CUDA events, after one warm-up)")

    phase("estimation profile")
    for name, p in problems.items():
        profile_summary(f"{name} parallel_kernel", lambda: est_k.solve(p),
                        solve_ms[(name, "parallel_kernel")])

    shapes = (scan_lane_counts(N_BLOCKS + 1, 1)
              + scan_lane_counts(N_BLOCKS + 1, RECORDS))
    return ({"launches": launches, "shapes": shapes, "nx": 4,
             "scans": [(N_BLOCKS + 1, 1), (N_BLOCKS + 1, RECORDS)],
             "pairwise_launches": lqt_kernel.launch_count()},
            {"model": model, "ts": ts, "yb": yb})


# ---------------------------------------------------------------------------
# 3b. nonlinear path: the iterated smoother on the coordinated turn
# ---------------------------------------------------------------------------

def nonlinear_path(lqt_kernel, lqt_scan) -> tuple:
    """The paper's Fig.-2 cell through ``Estimator.solve``; returns the scan
    kernel's launch count and scans on the path, and the launch shapes the
    per-level scan had; and the cell (model, problems, IEKS costs)."""
    from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
    from repro_torch.core import (
        Estimator,
        IteratedOptions,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
        TwoFilterOptions,
        simulate_nonlinear,
        time_grid,
    )

    cfg = CoordinatedTurnConfig()
    N = NL_BLOCKS * cfg.nsub
    model = cfg.model(dtype=torch.float64, device="cuda")
    ts = time_grid(cfg.t0, cfg.tf, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    _, y1 = simulate_nonlinear(model, ts, gm)                    # (N, ny)
    _, yb = simulate_nonlinear(model, ts[:, None].expand(-1, RECORDS), gm)
    torch.cuda.synchronize()
    log(f"coordinated turn, T={NL_BLOCKS} blocks x nsub={cfg.nsub} "
        f"(N={N}), mode={NL_MODE}, {NL_ITERS} iterations, float64, records: "
        f"single and {RECORDS} stacked; measurements simulated in "
        f"{time.perf_counter() - t0:.2f} s")
    problems = {"single": Problem.single(model, ts, y1),
                "stacked64": Problem.stacked(model, ts, yb.movedim(1, 0))}

    def est(method, inner, m=model):
        return Estimator(m, method=method, options=IteratedOptions(
            inner=inner, iterations=NL_ITERS))

    nsub = cfg.nsub
    ests = {"parallel_kernel": est("parallel_kernel",
                                   KernelOptions(nsub=nsub, mode=NL_MODE)),
            "parallel_rts": est("parallel_rts",
                                ParallelOptions(nsub=nsub, mode=NL_MODE)),
            "sequential_rts": est("sequential_rts",
                                  SequentialOptions(mode=NL_MODE))}
    est_rd = est("parallel_rts", ParallelOptions(nsub=nsub, mode="discrete"))
    est_tf = est("parallel_two_filter",
                 TwoFilterOptions(nsub=nsub, mode="discrete"))

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols = {k: ests["parallel_kernel"].solve(p) for k, p in problems.items()}
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    log(f"nonlinear path launches: lqt_scan {launches} (one per pass and "
        f"record layout), lqt_combine {lqt_kernel.launch_count()}")
    shapes = NL_ITERS * (scan_lane_counts(NL_BLOCKS + 1, 1)
                         + scan_lane_counts(NL_BLOCKS + 1, RECORDS))
    scans = NL_ITERS * [(NL_BLOCKS + 1, 1), (NL_BLOCKS + 1, RECORDS)]
    if launches != len(scans) or lqt_kernel.launch_count():
        raise AssertionError(f"nonlinear path: {launches} lqt_scan and "
                             f"{lqt_kernel.launch_count()} lqt_combine "
                             f"launches, expected {len(scans)} and 0")

    def max_dx(a, b):
        return float((a.x - b.x).abs().max())

    for name, p in problems.items():
        sol = sols[name]
        lead = () if name == "single" else (RECORDS,)
        for f, shape in (("x", lead + (N + 1, 5)), ("S", lead + (N + 1, 5, 5)),
                         ("cost", lead), ("cost_trace", lead + (NL_ITERS,)),
                         ("step_norms", lead + (NL_ITERS,))):
            t = getattr(sol, f)
            if (tuple(t.shape) != shape or t.device.type != "cuda"
                    or not bool(torch.isfinite(t).all())):
                raise AssertionError(f"{name}: {f} {tuple(t.shape)} on "
                                     f"{t.device} not finite or misshapen")
        trace = sol.cost_trace
        if not (torch.equal(sol.cost, trace[..., -1])
                and bool((trace[..., -1] < trace[..., 0]).all())):
            raise AssertionError(f"{name}: cost trace {trace} does not end "
                                 f"at cost below its start")
        log(f"  {name}: cost trace (record 0) "
            f"{[round(float(c), 3) for c in trace.reshape(-1, NL_ITERS)[0]]}"
            f", step norms {[f'{float(c):.2e}' for c in sol.step_norms.reshape(-1, NL_ITERS)[0]]}")
        gates = (
            ("parallel_kernel vs parallel_rts (cuda)", max_dx(
                sol, ests["parallel_rts"].solve(p)), NL_KERNEL_TOL),
            (f"parallel_kernel vs sequential_rts (cuda, {NL_MODE})",
             max_dx(sol, ests["sequential_rts"].solve(p)), NL_SEQ_TOL),
            ("parallel_two_filter vs parallel_rts (cuda, discrete)",
             max_dx(est_tf.solve(p), est_rd.solve(p)), NL_TF_TOL))
        for label, dx, tol in gates:
            ok = dx < tol
            log(f"  {name}: {label}: max|dx| {dx:.3e} (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: {label} max|dx| {dx:.3e} >= "
                                     f"{tol:.0e}")

    solve_ms = {}
    for name, p in problems.items():
        for label, e in ests.items():
            solve_ms[(name, label)] = median_solve_ms(e, p)
            log(f"  solve {name} {label}: median "
                f"{solve_ms[(name, label)]:.3f} ms over 5 runs (CUDA events, "
                f"after one warm-up)")
        log(f"  {name}: sequential_rts / parallel_kernel = "
            f"{solve_ms[(name, 'sequential_rts')] / solve_ms[(name, 'parallel_kernel')]:.2f}")

    phase("nonlinear profile")
    for name, p in problems.items():
        profile_summary(f"{name} parallel_kernel ({NL_ITERS} passes)",
                        lambda: ests["parallel_kernel"].solve(p),
                        solve_ms[(name, "parallel_kernel")])

    phase("nonlinear path in float32")
    model32 = cfg.model(dtype=torch.float32, device="cuda")
    est32 = est("parallel_kernel", KernelOptions(nsub=nsub, mode=NL_MODE),
                m=model32)
    for name, p in problems.items():
        p32 = (Problem.single(model32, ts, y1) if name == "single" else
               Problem.stacked(model32, ts, yb.movedim(1, 0)))
        sol32 = est32.solve(p32)
        dx = float((sol32.x.double() - sols[name].x).abs().max())
        log(f"  {name}: float32 parallel_kernel vs float64: max|dx| "
            f"{dx:.3e}, finite {bool(torch.isfinite(sol32.x).all())} "
            f"(reported, not gated); solve median "
            f"{median_solve_ms(est32, p32):.3f} ms")
    return ({"launches": launches, "shapes": shapes, "nx": 5, "scans": scans,
             "pairwise_launches": lqt_kernel.launch_count()},
            {"model": model, "nsub": nsub, "problems": problems,
             "ieks_cost": {k: sol.cost for k, sol in sols.items()}})


# ---------------------------------------------------------------------------
# 3c. sigma-point path: the posterior-linearisation smoother
# ---------------------------------------------------------------------------

def sigma_point_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """``method="sigma_point"`` on the nonlinear cell's records: unscented
    SLR on one record and on 64, cubature on one, each with the scan kernel
    as the inner method, against the same options with ``parallel_rts``;
    returns the scan kernel's launch count and scans on the path."""
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        SigmaPointOptions,
    )

    model, nsub, problems = cell["model"], cell["nsub"], cell["problems"]

    def est(lin, inner_method, inner):
        return Estimator(model, method="sigma_point", options=(
            SigmaPointOptions(linearization=lin, inner_method=inner_method,
                              inner=inner, iterations=NL_ITERS)))

    kernel = {lin: est(lin, "parallel_kernel",
                       KernelOptions(nsub=nsub, mode=NL_MODE))
              for lin in ("unscented", "cubature")}
    plain = {lin: est(lin, "parallel_rts",
                      ParallelOptions(nsub=nsub, mode=NL_MODE))
             for lin in ("unscented", "cubature")}
    # (linearisation, problem) per solve
    cases = {"single": ("unscented", "single"),
             "stacked64": ("unscented", "stacked64"),
             "single cubature": ("cubature", "single")}
    log(f"sigma points: {model.nx} states -> unscented "
        f"{kernel['unscented'].options.linearization.num_points(model.nx)} "
        f"and cubature "
        f"{kernel['cubature'].options.linearization.num_points(model.nx)} "
        f"points per grid point; {NL_ITERS} passes, {NL_MODE}, float64, on "
        f"{card()}")

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols, per_solve = {}, {}
    for name, (lin, pname) in cases.items():
        before = lqt_scan.launch_count()
        sols[name] = kernel[lin].solve(problems[pname])
        torch.cuda.synchronize()
        per_solve[name] = lqt_scan.launch_count() - before
    launches = lqt_scan.launch_count()
    log(f"sigma-point path launches: lqt_scan {per_solve} (one per pass), "
        f"lqt_combine {lqt_kernel.launch_count()}")
    if (any(n != NL_ITERS for n in per_solve.values())
            or lqt_kernel.launch_count()):
        raise AssertionError(f"sigma-point path: lqt_scan launches per "
                             f"solve {per_solve}, lqt_combine "
                             f"{lqt_kernel.launch_count()}; expected "
                             f"{NL_ITERS} each and 0")

    solve_ms = {}
    for name, (lin, pname) in cases.items():
        sol, p = sols[name], problems[pname]
        lead = () if pname == "single" else (RECORDS,)
        N = NL_BLOCKS * nsub
        for f, shape in (("x", lead + (N + 1, 5)), ("cost", lead),
                         ("cost_trace", lead + (NL_ITERS,))):
            t = getattr(sol, f)
            if (tuple(t.shape) != shape or t.device.type != "cuda"
                    or not bool(torch.isfinite(t).all())):
                raise AssertionError(f"sigma point {name}: {f} "
                                     f"{tuple(t.shape)} on {t.device} not "
                                     f"finite or misshapen")
        dx = float((sol.x - plain[lin].solve(p).x).abs().max())
        ok = dx < NL_KERNEL_TOL
        log(f"  {name}: parallel_kernel inner vs parallel_rts inner (cuda): "
            f"max|dx| {dx:.3e} (tol {NL_KERNEL_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"sigma point {name}: max|dx| {dx:.3e}")
        taylor = cell["ieks_cost"][pname]
        below = int((sol.cost <= taylor * (1 + 1e-6)).sum())
        log(f"  {name}: cost trace (record 0) "
            f"{[round(float(c), 3) for c in sol.cost_trace.reshape(-1, NL_ITERS)[0]]}"
            f"; final cost mean {float(sol.cost.mean()):.3f} against the "
            f"Taylor IEKS's {float(taylor.mean()):.3f} ({below} of "
            f"{sol.cost.numel()} records at or below it; printed, not gated)")
        solve_ms[name] = median_solve_ms(kernel[lin], p)
        log(f"  solve {name} sigma_point (parallel_kernel inner): median "
            f"{solve_ms[name]:.3f} ms over 5 runs (CUDA events, after one "
            f"warm-up) on {card()}")

    phase("sigma-point profile")
    for name in ("single", "stacked64"):
        lin, pname = cases[name]
        profile_summary(f"{name} sigma_point {lin} ({NL_ITERS} passes)",
                        lambda: kernel[lin].solve(problems[pname]),
                        solve_ms[name])
    records = [1 if cases[k][1] == "single" else RECORDS for k in cases]
    scans = NL_ITERS * [(NL_BLOCKS + 1, r) for r in records]
    shapes = NL_ITERS * [c for r in records
                         for c in scan_lane_counts(NL_BLOCKS + 1, r)]
    return {"launches": launches, "shapes": shapes, "nx": 5, "scans": scans,
            "pairwise_launches": lqt_kernel.launch_count()}


# ---------------------------------------------------------------------------
# 3d. ragged path: records of unequal lengths by pad-and-bucket
# ---------------------------------------------------------------------------

def ragged_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """64 Wiener records of lengths drawn uniformly from RAGGED_LENGTHS
    intervals (prefixes of the estimation cell's 64 records) as one ragged
    problem through ``parallel_kernel``: one stacked solve and one scan
    launch per bucket; returns the scan kernel's launch count and scans on
    the path."""
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
    )

    model, ts, yb = cell["model"], cell["ts"], cell["yb"]
    lengths = [int(n) for n in np.random.default_rng(SEED).integers(
        *RAGGED_LENGTHS, size=RECORDS, endpoint=True)]
    records = [(ts[:n + 1], yb[:n, i]) for i, n in enumerate(lengths)]
    problem = Problem.ragged(model, records)

    def n_pad_of(n):
        """The default bucket rule, written out: nsub * 2^ceil(log2(blocks))
        with blocks = ceil(n / nsub)."""
        return NSUB * 2 ** int(np.ceil(np.log2(-(-n // NSUB))))

    bucket = {}
    for i, n in enumerate(lengths):
        bucket.setdefault(n_pad_of(n), []).append(i)
    want = [(n_pad, len(idx), 2 ** int(np.ceil(np.log2(len(idx)))))
            for n_pad, idx in sorted(bucket.items())]
    log(f"Wiener velocity, {RECORDS} records of {min(lengths)}..."
        f"{max(lengths)} intervals ({sum(n % NSUB != 0 for n in lengths)} "
        f"not multiples of nsub={NSUB}), discrete, float64, default buckets "
        f"(n_pad, records, batch rows) {want}, on {card()}")

    est_k = Estimator(model, method="parallel_kernel",
                      options=KernelOptions(nsub=NSUB, mode="discrete"))
    est_p = Estimator(model, method="parallel_rts",
                      options=ParallelOptions(nsub=NSUB, mode="discrete"))
    est_s = Estimator(model, method="sequential_rts",
                      options=SequentialOptions(mode="discrete"),
                      device="cpu")

    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    sols = est_k.solve(problem)
    torch.cuda.synchronize()
    launches = lqt_scan.launch_count()
    report = sols[0].padding
    got = [(b.n_pad, b.records, b.batch) for b in report.buckets]
    log(f"ragged path launches: lqt_scan {launches} (one per bucket), "
        f"lqt_combine {lqt_kernel.launch_count()}")
    if (launches != len(want) or lqt_kernel.launch_count()
            or got != want or report.records != RECORDS
            or report.lengths != tuple(lengths)
            or report.real_intervals != sum(lengths)
            or any(s.padding is not report for s in sols)):
        raise AssertionError(f"ragged path: {launches} lqt_scan and "
                             f"{lqt_kernel.launch_count()} lqt_combine "
                             f"launches, buckets {got}; expected "
                             f"{len(want)}, 0 and {want}")
    for b in report.buckets:
        real = sum(lengths[i] for i in bucket[b.n_pad])
        log(f"  bucket n_pad={b.n_pad} ({b.n_pad // NSUB} blocks): "
            f"{b.records} records in {b.batch} rows ({b.recycled_rows} "
            f"recycled), interval utilisation {real / (b.n_pad * b.batch):.4f}")
    log(f"  report: {report.records} records, {report.real_intervals} real of "
        f"{report.solved_intervals} solved intervals (utilisation "
        f"{report.interval_utilisation:.4f}), row utilisation "
        f"{report.row_utilisation:.4f}")

    for i, (sol, n) in enumerate(zip(sols, lengths)):
        for f in ("x", "S", "v", "cost"):
            t = getattr(sol, f)
            if t.device.type != "cuda" or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"ragged record {i}: {f} not finite "
                                     f"on cuda")
        if tuple(sol.x.shape) != (n + 1, 4):
            raise AssertionError(f"ragged record {i}: x shape "
                                 f"{tuple(sol.x.shape)}")
    ref = est_p.solve(problem)
    dx = max(float((a.x - b.x).abs().max()) for a, b in zip(sols, ref))
    ok = dx < 1e-8
    log(f"  every record, parallel_kernel vs parallel_rts (cuda, the same "
        f"ragged problem): max|dx| {dx:.3e} (tol 1e-8) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ragged path: max|dx| {dx:.3e} against "
                             f"parallel_rts")
    for b in report.buckets:
        i = min(bucket[b.n_pad], key=lambda i: lengths[i])
        ts_i, y_i = records[i]
        seq = est_s.solve(Problem.single(model, ts_i.cpu(), y_i.cpu()))
        dx = float((sols[i].x.cpu() - seq.x).abs().max())
        ok = dx < 1e-6
        log(f"  bucket n_pad={b.n_pad}: shortest record ({lengths[i]} "
            f"intervals, padded by {b.n_pad - lengths[i]}) vs sequential_rts "
            f"on the CPU, unpadded: max|dx| {dx:.3e} (tol 1e-6) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ragged record {i}: max|dx| {dx:.3e} "
                                 f"against unpadded sequential_rts")

    ms = median_solve_ms(est_k, problem)
    log(f"  ragged solve parallel_kernel: median {ms:.3f} ms over 5 runs "
        f"(CUDA events around the whole solve: padding, {len(want)} stacked "
        f"solves, slicing; after one warm-up) on {card()}")
    phase("ragged profile")
    profile_summary(f"ragged {RECORDS} records parallel_kernel",
                    lambda: est_k.solve(problem), ms)
    scans = [(n_pad // NSUB + 1, rows) for n_pad, _, rows in want]
    shapes = [c for n, r in scans for c in scan_lane_counts(n, r)]
    return {"launches": launches, "shapes": shapes, "nx": 4, "scans": scans,
            "pairwise_launches": lqt_kernel.launch_count()}


# ---------------------------------------------------------------------------
# 3e-3g. the estimation serving engines
# ---------------------------------------------------------------------------

def recording_solves(estimator) -> list:
    """Wrap ``estimator.solve`` so that every call appends its problem's
    ``(records, intervals)``: the shape of each wave's stacked solve."""
    shapes, solve = [], estimator.solve

    def recorded(problem):
        shapes.append(tuple(problem.y.shape[:2]))
        return solve(problem)

    estimator.solve = recorded
    return shapes


def wave_path(launches: int, shapes, passes: int, nx: int) -> dict:
    """A path's scan record for the timing phase: the scans ``(elements,
    records)`` that the waves of ``shapes`` launch, and the launch shapes
    the per-level scan would have had for them."""
    scans = [(n // NSUB + 1, b) for b, n in shapes for _ in range(passes)]
    return {"launches": launches, "scans": scans, "nx": nx,
            "shapes": [c for n, r in scans for c in scan_lane_counts(n, r)],
            "pairwise_launches": 0}


def latency_line(name: str) -> str:
    from repro_torch import obs

    h = obs.histogram(name).summary()
    return (f"{name} p50 {h['p50'] * 1e3:.3f} ms, p99 {h['p99'] * 1e3:.3f} "
            f"ms over {h['count']} (obs histogram, bucket-interpolated)")


def profile_wave(label: str, step) -> None:
    """Time one wave (``step()``) by CUDA events, then profile another."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    step()
    stop.record()
    torch.cuda.synchronize()
    profile_summary(label, step, start.elapsed_time(stop))


def trajectory_engine_path(lqt_kernel, lqt_scan, cell: dict) -> dict:
    """The ragged cell's 64 records submitted in draw order to a
    ``TrajectoryEngine`` (``parallel_kernel``, waves of ENGINE_BATCH) and
    drained: waves per bucket, one scan launch per wave, every record
    against the port's ragged ``parallel_rts`` solve on the card."""
    from repro_torch import obs
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
    )
    from repro_torch.serving import TrajectoryEngine

    model, ts, yb = cell["model"], cell["ts"], cell["yb"]
    lengths = [int(n) for n in np.random.default_rng(SEED).integers(
        *RAGGED_LENGTHS, size=RECORDS, endpoint=True)]
    records = [(ts[:n + 1], yb[:n, i]) for i, n in enumerate(lengths)]
    # records arrive from the host, as a client would submit them
    host = [(t.cpu().numpy(), y.cpu().numpy()) for t, y in records]
    counts = {}
    for n in lengths:
        n_pad = NSUB * 2 ** int(np.ceil(np.log2(-(-n // NSUB))))
        counts[n_pad] = counts.get(n_pad, 0) + 1
    want_waves = {n_pad: -(-c // ENGINE_BATCH) for n_pad, c in counts.items()}
    want_recycled = sum(w * ENGINE_BATCH - counts[n]
                        for n, w in want_waves.items())
    log(f"Wiener velocity, the ragged cell's {RECORDS} records submitted in "
        f"draw order to TrajectoryEngine(batch={ENGINE_BATCH}, "
        f"method='parallel_kernel', discrete, float64), buckets (n_pad: "
        f"records) {dict(sorted(counts.items()))}, on {card()}")

    opts = KernelOptions(nsub=NSUB, mode="discrete")
    eng = TrajectoryEngine(model, batch=ENGINE_BATCH,
                           method="parallel_kernel", options=opts)
    shapes = recording_solves(eng.estimator)
    obs.reset()
    obs.enable()
    lqt_kernel.reset_launch_count()
    lqt_scan.reset_launch_count()
    t0 = time.perf_counter()
    tickets = [eng.submit(t, y) for t, y in host]
    eng.run()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = lqt_scan.launch_count()
    got = dict(eng.collect(tickets=tickets))
    snap = obs.snapshot()
    waves = {}
    for _, n in shapes:
        waves[n] = waves.get(n, 0) + 1
    log(f"trajectory engine launches: lqt_scan {launches} ({eng.waves} "
        f"waves), lqt_combine {lqt_kernel.launch_count()}; waves per bucket "
        f"{dict(sorted(waves.items()))}")
    c = snap["counters"]
    if (waves != want_waves or launches != eng.waves
            or lqt_kernel.launch_count() or len(got) != RECORDS
            or c.get("engine.completed") != RECORDS
            or c.get("engine.recycled_rows") != want_recycled
            or eng.recycled_rows != want_recycled):
        raise AssertionError(
            f"trajectory engine: waves {waves} (want {want_waves}), "
            f"{launches} lqt_scan launches for {eng.waves} waves, "
            f"{lqt_kernel.launch_count()} lqt_combine, completed "
            f"{c.get('engine.completed')}, recycled rows "
            f"{c.get('engine.recycled_rows')} (want {want_recycled})")
    ref = Estimator(model, method="parallel_rts",
                    options=ParallelOptions(nsub=NSUB, mode="discrete")
                    ).solve(Problem.ragged(model, records))
    dx = 0.0
    for t, n, r in zip(tickets, lengths, ref):
        sol = got[t]
        if (tuple(sol.x.shape) != (n + 1, 4) or sol.x.device.type != "cuda"
                or not bool(torch.isfinite(sol.x).all())):
            raise AssertionError(f"trajectory engine ticket {t}: x "
                                 f"{tuple(sol.x.shape)} on {sol.x.device}")
        dx = max(dx, float((sol.x - r.x).abs().max()))
    ok = dx < 1e-8
    log(f"  every record, engine (parallel_kernel) vs Estimator "
        f"parallel_rts on Problem.ragged (cuda): max|dx| {dx:.3e} (tol "
        f"1e-8) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"trajectory engine: max|dx| {dx:.3e}")
    occ = snap["histograms"]["engine.wave_occupancy"]
    log(f"  drain: {RECORDS} records in {drain_s * 1e3:.3f} ms wall "
        f"(submit + run, obs on) = {RECORDS / drain_s:.1f} records/s; "
        f"{latency_line('engine.record_latency_seconds')}; mean wave "
        f"occupancy {occ['mean']:.4f}; padding waste "
        f"{snap['gauges']['engine.padding_waste']:.4f}; on {card()}")
    obs.disable()
    # one profiled wave of the largest bucket
    big = max(counts)
    wave = [r for r, n in zip(host, lengths) if n > big // 2][:ENGINE_BATCH]

    def one_wave():
        for t, y in wave:
            eng.submit(t, y)
        eng.step()
        eng.collect()
        torch.cuda.synchronize()

    phase("trajectory engine profile")
    profile_wave(f"one engine wave ({len(wave)} records, n_pad={big})",
                 one_wave)
    return wave_path(launches, shapes[:launches], 1, 4)


def stream_pass(eng, ts, ys, late=None):
    """Round-robin STREAM_CHUNK-interval pushes of every track, draining
    after each round; ``late`` (a per-track boolean mask over the
    intervals) holds those measurements back one round.  Returns the track
    ids, windows solved and push summaries."""
    N = ys[0].shape[0]
    tids = [eng.open_track(float(ts[0])) for _ in ys]
    windows, totals = 0, {"merged": 0, "dropped_late": 0, "offered": 0}
    rounds = range(0, N + (STREAM_CHUNK if late is not None else 0),
                   STREAM_CHUNK)
    for i in rounds:
        for k, (tid, y) in enumerate(zip(tids, ys)):
            if late is None:
                idx = np.arange(i, min(i + STREAM_CHUNK, N))
            else:
                prev = np.arange(max(0, i - STREAM_CHUNK), i)
                cur = np.arange(i, min(i + STREAM_CHUNK, N))
                idx = np.sort(np.concatenate(
                    [prev[late[k][prev]], cur[~late[k][cur]]]))
            if idx.size:
                res = eng.push(tid, ts[idx + 1], y[idx])
                totals["offered"] += idx.size
                totals["merged"] += res["merged"]
                totals["dropped_late"] += res["dropped_late"]
        windows += eng.run()
    return tids, windows, totals


def streaming_linear_path(lqt_kernel, lqt_scan) -> dict:
    """STREAM_TRACKS Wiener tracks of STREAM_N intervals through a
    ``StreamingEngine`` (lag STREAM_LAG, waves of STREAM_BATCH,
    ``parallel_kernel``): a warm-up pass on other tracks, the measured
    in-order pass, then the late pass; each against offline solves."""
    from repro_torch import obs
    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        simulate_linear,
        time_grid,
    )
    from repro_torch.serving import StreamingEngine

    model = WienerVelocityConfig(p0=1.0).model(device="cuda")
    N, dt = STREAM_N, 0.1
    tsd = time_grid(0.0, N * dt, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    _, yd = simulate_linear(model, tsd[:, None].expand(-1, STREAM_TRACKS),
                            gm)
    _, yw = simulate_linear(model, tsd[:, None].expand(-1, STREAM_BATCH), gm)
    ts = tsd.cpu().numpy()
    ys = [y.numpy() for y in yd.movedim(1, 0).cpu()]
    warm = [y.numpy() for y in yw.movedim(1, 0).cpu()]
    opts = KernelOptions(nsub=NSUB, mode="discrete")
    offline = Estimator(model, method="parallel_rts",
                        options=ParallelOptions(nsub=NSUB, mode="discrete"))
    gate = list(range(0, STREAM_TRACKS, STREAM_TRACKS // 4))
    refs = {k: offline.solve(Problem.single(model, tsd, yd[:, k])).x.cpu()
            for k in gate}
    out = wave_path(0, [], 1, 4)

    def measured(label, eng, keep, late=None):
        shapes = recording_solves(eng.estimator)
        obs.reset()
        obs.enable()
        lqt_kernel.reset_launch_count()
        lqt_scan.reset_launch_count()
        t0 = time.perf_counter()
        tids, windows, totals = stream_pass(eng, ts, ys, late=late)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lqt_scan.launch_count()
        snap = obs.snapshot()
        c = snap["counters"]
        log(f"{label}: {windows} windows in {eng.waves} waves "
            f"({len(shapes)} solves), {wall * 1e3:.3f} ms wall = "
            f"{windows / wall:.1f} windows/s; "
            f"{latency_line('stream.window_latency_seconds')}; lqt_scan "
            f"{launches}, lqt_combine {lqt_kernel.launch_count()}; waves per "
            f"bucket {dict(sorted(collections.Counter(n for _, n in shapes).items()))}"
            f"; evicted {c.get('stream.evicted_intervals', 0)}, late merges "
            f"{c.get('stream.late_merges', 0)}, late drops "
            f"{c.get('stream.late_drops', 0)}, deferred evictions "
            f"{c.get('stream.deferred_evictions', 0)}, padding waste "
            f"{snap['gauges']['stream.padding_waste']:.4f}, mean occupancy "
            f"{snap['histograms']['stream.wave_occupancy']['mean']:.4f}; "
            f"on {card()}")
        if (launches != eng.waves or launches != len(shapes)
                or lqt_kernel.launch_count()
                or c.get("stream.late_drops", 0)):
            raise AssertionError(
                f"{label}: {launches} lqt_scan launches for {eng.waves} "
                f"waves, {lqt_kernel.launch_count()} lqt_combine, late drops "
                f"{c.get('stream.late_drops', 0)}")
        worst = 0.0
        for k in gate:
            x = eng.estimate(tids[k]).x
            ref = refs[k]
            if (tuple(x.shape) != tuple(ref.shape)
                    or not bool(torch.isfinite(x).all())):
                raise AssertionError(f"{label} track {k}: x "
                                     f"{tuple(x.shape)}")
            err = float((x[-keep - 1:] - ref[-keep - 1:]).abs().max())
            worst = max(worst, err / float(ref.abs().max()))
        ok = worst < 1e-9
        log(f"  final {keep + 1} states of tracks {gate} vs offline "
            f"parallel_rts of the whole {N}-interval record (cuda): max "
            f"|dx| / max|x| {worst:.3e} (tol 1e-9) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: window vs offline {worst:.3e}")
        obs.disable()
        done = wave_path(launches, shapes, 1, 4)
        for key in ("launches", "scans", "shapes"):
            out[key] += done[key]
        return eng, tids

    log(f"Wiener velocity (p0 = 1), {STREAM_TRACKS} tracks of {N} "
        f"intervals (dt = {dt}), StreamingEngine(lag={STREAM_LAG}, "
        f"batch={STREAM_BATCH}, method='parallel_kernel', discrete, "
        f"float64), round-robin chunks of {STREAM_CHUNK} intervals, a drain "
        f"after each round")
    eng = StreamingEngine(model, lag=STREAM_LAG, batch=STREAM_BATCH,
                          method="parallel_kernel", options=opts)
    t0 = time.perf_counter()
    wtids, wwin, _ = stream_pass(eng, ts, warm)
    for tid in wtids:
        eng.close(tid)
    torch.cuda.synchronize()
    log(f"  warm-up pass: {len(warm)} other tracks, {wwin} windows in "
        f"{time.perf_counter() - t0:.2f} s")
    eng.waves = 0
    eng, tids = measured("in-order pass", eng, STREAM_LAG)

    phase("streaming engine profile")
    nxt = [(tid, y) for tid, y in zip(tids, ys)][:STREAM_BATCH]
    extra = [0]

    def one_wave():
        # one more chunk for STREAM_BATCH tracks, past their records' end
        t1 = ts[-1] + dt * (1 + np.arange(STREAM_CHUNK) + extra[0])
        extra[0] += STREAM_CHUNK
        for tid, y in nxt:
            eng.push(tid, t1, y[:STREAM_CHUNK])
        eng.step()
        torch.cuda.synchronize()

    profile_wave(f"one streaming wave ({STREAM_BATCH} windows of "
                 f"~{STREAM_LAG + STREAM_CHUNK} intervals)", one_wave)

    phase("streaming engine, late pass")
    late_lag, slack = STREAM_CHUNK // 2, STREAM_CHUNK
    rng = np.random.default_rng(SEED + 1)
    held = [rng.random(N) < 0.10 for _ in ys]
    log(f"late pass: lag {late_lag}, reorder_slack {slack}, 10 % of each "
        f"track's measurements ({sum(int(h.sum()) for h in held)} in all) "
        f"held back one round")
    eng = StreamingEngine(model, lag=late_lag, batch=STREAM_BATCH,
                          method="parallel_kernel", options=opts,
                          reorder_slack=slack)
    measured("late pass", eng, late_lag + slack, late=held)
    return out


def streaming_sigma_point_path(lqt_kernel, lqt_scan) -> dict:
    """SP_STREAM_TRACKS coordinated-turn tracks through two
    ``StreamingEngine(method="sigma_point")``s, the inner method
    ``parallel_kernel`` and ``parallel_rts``, on the same pushes."""
    from repro_torch import obs
    from repro_torch.configs.coordinated_turn import CoordinatedTurnConfig
    from repro_torch.core import (
        KernelOptions,
        ParallelOptions,
        simulate_nonlinear,
        time_grid,
    )
    from repro_torch.serving import StreamingEngine
    from repro_torch.serving.waves import robust_default_options

    cfg = CoordinatedTurnConfig()
    model = cfg.model(device="cuda")
    N = SP_STREAM_N
    tsd = time_grid(cfg.t0, cfg.tf, N, device="cuda")
    gm = torch.Generator(device="cuda").manual_seed(SEED)
    _, yd = simulate_nonlinear(
        model, tsd[:, None].expand(-1, SP_STREAM_TRACKS), gm)
    ts = tsd.cpu().numpy()
    ys = [y.numpy() for y in yd.movedim(1, 0).cpu()]
    base = robust_default_options("sigma_point")
    passes = base.iterations
    log(f"coordinated turn, {SP_STREAM_TRACKS} tracks of {N} intervals "
        f"(dt = {(cfg.tf - cfg.t0) / N}), StreamingEngine(lag={STREAM_LAG}, "
        f"batch={STREAM_BATCH}, method='sigma_point', unscented, {passes} "
        f"passes, discrete inner mode, float64), chunks of {STREAM_CHUNK}")
    est = {}
    for inner_method, inner in (
            ("parallel_kernel", KernelOptions(nsub=NSUB, mode="discrete")),
            ("parallel_rts", ParallelOptions(nsub=NSUB, mode="discrete"))):
        eng = StreamingEngine(
            model, lag=STREAM_LAG, batch=STREAM_BATCH, method="sigma_point",
            options=base.replace(inner_method=inner_method, inner=inner))
        shapes = recording_solves(eng.estimator)
        obs.reset()
        obs.enable()
        lqt_kernel.reset_launch_count()
        lqt_scan.reset_launch_count()
        t0 = time.perf_counter()
        tids, windows, _ = stream_pass(eng, ts, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lqt_scan.launch_count()
        log(f"{inner_method} inner: {windows} windows in {eng.waves} waves, "
            f"{wall * 1e3:.3f} ms wall = {windows / wall:.1f} windows/s; "
            f"{latency_line('stream.window_latency_seconds')}; lqt_scan "
            f"{launches}, lqt_combine {lqt_kernel.launch_count()}; on "
            f"{card()}")
        want = eng.waves * passes if inner_method == "parallel_kernel" else 0
        if launches != want or lqt_kernel.launch_count():
            raise AssertionError(
                f"sigma-point streaming ({inner_method}): {launches} "
                f"lqt_scan launches, expected {want}; lqt_combine "
                f"{lqt_kernel.launch_count()}")
        obs.disable()
        est[inner_method] = [eng.estimate(t).x for t in tids]
        if inner_method == "parallel_kernel":
            out = wave_path(launches, shapes, passes, 5)
    dx = 0.0
    for k, r in zip(est["parallel_kernel"], est["parallel_rts"]):
        if tuple(k.shape) != (N + 1, 5) or not bool(torch.isfinite(k).all()):
            raise AssertionError(f"sigma-point streaming: x {tuple(k.shape)}")
        dx = max(dx, float((k - r).abs().max()))
    ok = dx < NL_KERNEL_TOL
    log(f"  every track's final estimate, parallel_kernel inner vs "
        f"parallel_rts inner: max|dx| {dx:.3e} (tol {NL_KERNEL_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"sigma-point streaming: max|dx| {dx:.3e}")
    return out


# ---------------------------------------------------------------------------
# 3h. the scan kernel at the paths' scans; lqt_combine at the per-level shapes
# ---------------------------------------------------------------------------

def per_level_suffix_scan(elems):
    """The per-level design the scan kernel replaces, as the port ran it
    before: lane-major copies of the elements, a flip, one pairwise-kernel
    launch per tree level over dense copies of the level's slices
    (``core.pscan.associative_scan`` over the lane axis), interleaves, and
    the flip and layout back."""
    from repro_torch.core.pscan import associative_scan
    from repro_torch.kernels.lqt_combine import ops

    lanes = tuple(torch.flip(a, (-1,)) for a in ops._to_lanes(elems))
    out = associative_scan(
        lambda a, b: ops._combine_lanes(b, a, block_size=128), lanes,
        axis=-1)
    return ops._from_lanes(tuple(torch.flip(a, (-1,)) for a in out))


def scan_timing(g, lqt_scan, lqt_ref, paths: dict) -> dict:
    """The report row of ``lqt_scan``: its time summed over every path's
    scans (CUDA events around a CUDA-graph replay of back-to-back scans, or
    around eager calls where capture is refused), beside eager calls, the
    plain scan, its own bound and the summed per-launch bound of the tree's
    combines (the per-level design's yardstick); per path too.  Then a depth
    sweep over one record."""
    row = {"name": "lqt_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/lqt_combine/csrc/lqt_scan.cu",
           "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
           "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "bound_by": None, "library_ms": None,
           "eager_ms": 0.0, "per_combine_bound_ms": 0.0, "timing": None,
           "paths": {}}
    methods = set()
    for path, info in paths.items():
        nx = info["nx"]
        t = dict.fromkeys(("ms", "eager_ms", "plain_ms", "bound_ms",
                           "per_level_ms", "per_level_eager_ms",
                           "max_abs_err"), 0.0)
        bound_by = set()
        for n, R in sorted(set(info["scans"])):
            mult = info["scans"].count((n, R))
            e = random_elems(n, R, nx, torch.float64, g)
            got = lqt_scan.lqt_scan(e, reverse=True)
            want = lqt_ref.lqt_scan_ref(e, reverse=True)
            err = compare(got, want)[0]
            grid = dict(lqt_scan.last_launch)

            def kern():
                return lqt_scan.lqt_scan(e, reverse=True)

            def plain():
                return lqt_ref.lqt_scan_ref(e, reverse=True)

            def per_level():
                return per_level_suffix_scan(e)

            ms, how = scan_time_ms(kern, 20)
            eager = cuda_time_ms(kern, 20)
            plain_ms = cuda_time_ms(plain, 3)
            old_ms, old_how = scan_time_ms(per_level, 5)
            old_eager = cuda_time_ms(per_level, 5)
            combines = sum(scan_lane_counts(n, R))
            nbytes = scan_bytes(n, R, nx, 8)
            b_ms, b_by = bound(nbytes, combines * combine_flops(nx),
                               torch.float64)
            log(f"  {path}: scan of {n} elements x {R} records (nx={nx}, "
                f"float64, {combines} combines), x{mult} on the path: "
                f"{ms:.5f} ms ({how}; eager calls {eager:.5f} ms), plain "
                f"scan {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
                f"{nbytes / 1e6:.2f} MB, "
                f"{combines * combine_flops(nx) / 1e6:.1f} MFLOP), "
                f"{b_ms / ms:.3f} of the bound; grid {grid}; the per-level "
                f"design (launches and copies) {old_ms:.5f} ms ({old_how}; "
                f"eager calls {old_eager:.5f} ms)")
            methods.add(how)
            bound_by.add(b_by)
            t["ms"] += mult * ms
            t["eager_ms"] += mult * eager
            t["plain_ms"] += mult * plain_ms
            t["per_level_ms"] += mult * old_ms
            t["per_level_eager_ms"] += mult * old_eager
            t["bound_ms"] += mult * b_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
            del e, got, want
        shapes = info["shapes"]
        pc_ms, _ = bound(sum(B * combine_bytes(nx, 8) for B in shapes),
                         sum(B * combine_flops(nx) for B in shapes),
                         torch.float64)
        by = "bytes" if "bytes" in bound_by else "operations"
        log(f"    {path} path, {info['launches']} scans: {t['ms']:.4f} ms "
            f"(eager calls {t['eager_ms']:.4f} ms), plain {t['plain_ms']:.4f}"
            f" ms, bound {t['bound_ms']:.5f} ms ({by}; "
            f"{t['bound_ms'] / t['ms']:.3f} reached), the per-level design's "
            f"bound (its {len(shapes)} launches' combines) {pc_ms:.5f} ms; "
            f"the per-level design itself {t['per_level_ms']:.4f} ms (eager "
            f"calls {t['per_level_eager_ms']:.4f} ms)")
        row["paths"][path] = {"launches": info["launches"], "ms": t["ms"],
                              "eager_ms": t["eager_ms"],
                              "plain_ms": t["plain_ms"],
                              "bound_ms": t["bound_ms"], "bound_by": by,
                              "per_combine_bound_ms": pc_ms,
                              "per_level_ms": t["per_level_ms"],
                              "per_level_eager_ms": t["per_level_eager_ms"]}
        row["launches"] += info["launches"]
        row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
        for k in ("ms", "eager_ms", "plain_ms", "bound_ms"):
            row[k] += t[k]
        row["per_combine_bound_ms"] += pc_ms
        row["bound_by"] = ("bytes" if "bytes" in (row["bound_by"], by)
                           else by)
    row["timing"] = "+".join(sorted(methods))
    for nx in (4, 5):
        pts = []
        for n in SCAN_SWEEP:
            e = random_elems(n, 1, nx, torch.float64, g)
            ms, how = scan_time_ms(lambda: lqt_scan.lqt_scan(e, reverse=True),
                                   30)
            pts.append((n, ms))
        levels = np.array([n.bit_length() - 1 for n, _ in pts], float)
        slope, icept = np.polyfit(levels, np.array([ms for _, ms in pts]), 1)
        log(f"  depth sweep, one record, nx={nx}, float64 ({how}): "
            + ", ".join(f"n={n} {ms:.5f}" for n, ms in pts)
            + f" ms; least-squares slope {slope * 1e3:.3f} us per tree level"
            f" (a down and an up phase), intercept {icept * 1e3:.3f} us")
        row[f"sweep_us_per_level_nx{nx}"] = slope * 1e3
    return row


def combine_timing(g, lqt_kernel, lqt_ref, paths: dict) -> dict:
    """The report row of the pairwise ``lqt_combine``: the paths now run
    their scans through ``lqt_scan``, so its launches there are 0; its time
    is summed over the launch shapes the per-level scan had on each path
    (CUDA events around a CUDA-graph replay of back-to-back launches), beside
    the same launches called eagerly, the profiler's summed kernel time, the
    plain version and the bound."""
    row = {"name": "lqt_combine", "route": "cuda",
           "source": "src/repro_torch/kernels/lqt_combine/csrc/"
                     "lqt_combine.cu",
           "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
           "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "bound_by": None, "library_ms": None,
           "eager_ms": 0.0, "profiler_ms": 0.0,
           "note": "off the main paths since the scan kernel runs their "
                   "scans; timed at the per-level scan's launch shapes",
           "paths": {}}
    for path, info in paths.items():
        shapes, nx = info["shapes"], info["nx"]
        t = dict.fromkeys(("ms", "eager_ms", "profiler_ms", "plain_ms",
                           "bytes", "flops", "max_abs_err"), 0.0)
        for B in sorted(set(shapes)):
            mult = shapes.count(B)
            ops1, ops2 = random_pairs(nx, B, torch.float64, g)
            got = lqt_kernel.lqt_combine_lanes(ops1, ops2)
            want = lqt_ref.lqt_combine_lanes_ref(ops1, ops2)
            t["max_abs_err"] = max(t["max_abs_err"], compare(got, want)[0])

            def kern():
                return lqt_kernel.lqt_combine_lanes(ops1, ops2)

            def plain():
                return lqt_ref.lqt_combine_lanes_ref(ops1, ops2)

            t["ms"] += mult * graph_time_ms(kern, 50)
            t["eager_ms"] += mult * cuda_time_ms(kern, 50)
            t["profiler_ms"] += mult * device_time_ms(kern, 20)
            t["plain_ms"] += mult * cuda_time_ms(plain, 10)
            t["bytes"] += mult * B * combine_bytes(nx, 8)
            t["flops"] += mult * B * combine_flops(nx)
            del ops1, ops2, got, want
        b_ms, b_by = bound(t["bytes"], t["flops"], torch.float64)
        log(f"  {path} path's per-level shapes (nx={nx}, float64): "
            f"{len(shapes)} launches, lanes per launch {sorted(set(shapes))}")
        log(f"    summed over those launches: kernel {t['ms']:.4f} ms "
            f"(CUDA events, graph replay; eager calls {t['eager_ms']:.4f} "
            f"ms; profiler {t['profiler_ms']:.4f} ms), plain version "
            f"{t['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
            f"{t['bytes']:.0f} B, {t['flops']:.0f} FLOP): "
            f"{b_ms / t['ms']:.3f} of the bound")
        row["paths"][path] = {
            "launches": info["pairwise_launches"],
            "per_level_launches": len(shapes), "ms": t["ms"],
            "eager_ms": t["eager_ms"], "profiler_ms": t["profiler_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by}
        row["launches"] += info["pairwise_launches"]
        row["max_abs_err"] = max(row["max_abs_err"], t["max_abs_err"])
        for k in ("ms", "eager_ms", "profiler_ms", "plain_ms"):
            row[k] += t[k]
        row["bound_ms"] += b_ms
        row["bound_by"] = ("bytes" if "bytes" in (row["bound_by"], b_by)
                           else b_by)
    for nx, B in ((5, 65536), (4, 65536), (4, 1024), (4, 1)):
        ops1, ops2 = random_pairs(nx, B, torch.float64, g)

        def kern():
            return lqt_kernel.lqt_combine_lanes(ops1, ops2)

        ms = graph_time_ms(kern, 100)
        nbytes = B * combine_bytes(nx, 8)
        log(f"  one launch, nx={nx}, B={B} lanes: {ms:.5f} ms (graph "
            f"replay; eager {cuda_time_ms(kern, 100):.5f} ms, profiler "
            f"{device_time_ms(kern, 50):.5f} ms), bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"({nbytes / ms / 1e9:.3f} TB/s achieved)")
    return row


# ---------------------------------------------------------------------------
# 4-6. language-model serving path
# ---------------------------------------------------------------------------

def lm_requests(cfg, Request):
    rng = np.random.default_rng(SEED)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, LM_PROMPT)
                    .astype(np.int32), max_new_tokens=LM_NEW)
            for _ in range(LM_REQUESTS)]


def serving_path(cfg, params, fa_kernel, ssd_kernel) -> dict:
    """Returns the launch counts of the two LM kernels on the path."""
    from repro_torch.serving import Request, ServeEngine

    engine = ServeEngine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN)
    reqs = lm_requests(cfg, Request)
    waves = -(-LM_REQUESTS // LM_BATCH)
    fa_kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    t0 = time.perf_counter()
    done = engine.generate(reqs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.launch_count(),
                "ssd_chunked": ssd_kernel.launch_count()}
    by_variant = {f"{name} {v}": kernel.launch_count(v)
                  for name, kernel in (("flash_attention", fa_kernel),
                                       ("ssd_chunked", ssd_kernel))
                  for v in kernel.VARIANTS}
    log(f"main path launches ({waves} waves): {launches}, by variant "
        f"{by_variant}; first generate (kernels already built) "
        f"{first_s:.2f} s")
    for name, n in launches.items():
        if n != cfg.num_layers * waves:
            raise AssertionError(f"{name}: {n} launches, expected "
                                 f"{cfg.num_layers} per wave x {waves}")
        # bf16 at hymba's widths: every launch is the tensor-core variant
        if by_variant[f"{name} mma"] != n:
            raise AssertionError(f"{name}: {by_variant} launches, expected "
                                 f"all {n} of the mma variant")
    for r in done:
        if r.out.shape != (LM_NEW,) or not (
                (r.out >= 0) & (r.out < cfg.vocab_size)).all():
            raise AssertionError(f"bad output tokens {r.out}")
    log(f"  {len(done)} requests, {LM_NEW} tokens each; first request's "
        f"tokens {r.out[:8].tolist()}...")

    # timed second run of the whole path (everything warm)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    done = engine.generate(lm_requests(cfg, Request))
    stop.record()
    torch.cuda.synchronize()
    gen_ms = start.elapsed_time(stop)
    new_tokens = sum(len(r.out) for r in done)
    log(f"  generate: {gen_ms:.1f} ms for {LM_REQUESTS} requests x "
        f"{LM_PROMPT} prompt tokens, {new_tokens} new tokens -> "
        f"{new_tokens / gen_ms * 1e3:.1f} new tokens/s, "
        f"{(LM_REQUESTS * LM_PROMPT + new_tokens) / gen_ms * 1e3:.0f} "
        f"tokens/s with the prompts (CUDA events)")

    toks = torch.as_tensor(np.stack([r.prompt for r in done[:LM_BATCH]]),
                           dtype=torch.int64, device="cuda")
    times = []
    for _ in range(3):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        logits, caches = engine._prefill(toks)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    prefill_ms = statistics.median(times)
    if tuple(logits.shape) != (LM_BATCH, 1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("prefill logits not finite or misshapen")
    log(f"  prefill: median {prefill_ms:.3f} ms per wave of {LM_BATCH} x "
        f"{LM_PROMPT} tokens over 3 runs ({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.0f} "
        f"tokens/s)")
    cur = torch.argmax(logits[:, -1], dim=-1)
    steps = []
    for _ in range(LM_NEW - 1):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        start.record()
        logits, caches = engine._decode(cur, caches)
        cur = torch.argmax(logits, dim=-1)
        stop.record()
        torch.cuda.synchronize()
        steps.append(start.elapsed_time(stop))
    decode_ms = statistics.median(steps)
    log(f"  decode: median {decode_ms:.3f} ms per step of {LM_BATCH} tokens "
        f"over {len(steps)} steps (min {min(steps):.3f}, max "
        f"{max(steps):.3f}; {LM_BATCH / decode_ms * 1e3:.1f} tokens/s)")

    phase("serving profile")
    profile_summary("prefill (one wave)", lambda: engine._prefill(toks),
                    prefill_ms)
    profile_summary("decode step", lambda: engine._decode(cur, caches),
                    decode_ms)
    return launches


def cross_path(cfg, params) -> None:
    """Kernel path vs plain path on the same weights in float32."""
    from repro_torch.models import transformer
    from repro_torch.serving import Request

    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def to32(tree):
        return ({k: to32(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    p32 = to32(params)
    reqs = lm_requests(cfg, Request)[:LM_BATCH]
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs]),
                           dtype=torch.int64, device="cuda")
    out = {}
    for use_kernel in (True, False):
        logits, _ = transformer.prefill(p32, {"tokens": toks}, cfg32,
                                        LM_MAX_LEN, use_kernel=use_kernel)
        out[use_kernel] = logits[:, -1, :cfg.vocab_size]
        torch.cuda.synchronize()
    err = float((out[True] - out[False]).abs().max())
    scale = float(out[False].abs().max())
    tok_k = torch.argmax(out[True], dim=-1)
    tok_p = torch.argmax(out[False], dim=-1)
    same = bool((tok_k == tok_p).all())
    log(f"  float32 prefill logits, kernel path vs plain path, "
        f"{LM_BATCH} x {LM_PROMPT} tokens: max abs err {err:.3e}, "
        f"relative to max|logit| {err / scale:.3e} (tol {CROSS_RTOL:.0e}); "
        f"first tokens equal: {same} ({tok_k.tolist()})")
    if not (err <= CROSS_RTOL * scale and same):
        raise AssertionError("kernel path disagrees with the plain path")


def in_turns(fns: dict, reps: dict, rounds: int = 2) -> dict:
    """``{name: (ms, profiler ms)}`` per call of each function, timed in
    turns (a, b, ..., then again) so that the card's state is shared: CUDA
    events around back-to-back calls (the kernels here run longer than
    their host launch), and beside it the profiler's summed kernel time."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append((cuda_time_ms(fn, reps[name]),
                                device_time_ms(fn, reps[name])))
    return {name: tuple(statistics.mean(x) for x in zip(*t))
            for name, t in times.items()}


def lm_kernel_timing(cfg, launches, fa_kernel, fa_ref, ssd_kernel, ssd_ref,
                     g, errs) -> list:
    """Report rows of the two LM kernels at the serving path's shapes: the
    tensor-core kernel the path runs, the simt design at the same shape
    (called by variant: the path never takes it), the plain version, the
    library call where there is one, and the bound."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    rows = []
    # flash attention: q (8, 25, 2048, 64), k/v (8, 5, 2048, 64), window
    case = (LM_BATCH, cfg.num_heads, cfg.num_kv_heads, LM_PROMPT, LM_PROMPT,
            cfg.hd, True, cfg.window)
    q, k, v = fa_inputs(case, bf16, g)
    B, Hq, Hkv, L, _, D, _, W = case
    which = fa_kernel.variant(bf16, D)
    t = in_turns({
        which: lambda: fa_kernel.flash_attention(q, k, v, causal=True,
                                                 window=W),
        "simt": lambda: fa_kernel._run("simt", q, k, v, causal=True,
                                       window=W)},
        {which: 20, "simt": 5})
    (ms, prof), (prev, prev_prof) = t[which], t["simt"]
    plain = cuda_time_ms(lambda: fa_ref.mha_ref(q, k, v, causal=True,
                                                window=W), 3)
    rows_ = torch.arange(L, device="cuda")[:, None]
    cols = torch.arange(L, device="cuda")[None, :]
    band = (rows_ >= cols) & (rows_ - cols < W)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=band, enable_gqa=True), 5)
    pairs = int(band.sum()) * B * Hq
    flops = 4 * D * pairs                       # QK^T and PV inside the band
    nbytes = 2 * (2 * B * Hq * L * D + 2 * B * Hkv * L * D)
    b_ms, b_by = bound(nbytes, flops, bf16)
    n = launches["flash_attention"]
    log(f"  flash_attention {case} bf16, per launch (CUDA events): kernel "
        f"({which}) {ms:.4f} ms (profiler {prof:.4f} ms), the simt design "
        f"{prev:.4f} ms (profiler {prev_prof:.4f} ms), plain "
        f"{plain:.4f} ms, scaled_dot_product_attention with the band mask "
        f"(enable_gqa=True) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"{flops / ms / 1e9:.2f} TFLOP/s achieved ({b_ms / ms:.3f} of the "
        f"bound; simt {flops / prev / 1e9:.2f} TFLOP/s)")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:92",
        "launches": n, "paths": {"serving": {"launches": n}},
        "max_abs_err": errs["flash_attention"],
        "ms": ms * n, "plain_ms": plain * n, "bound_ms": b_ms * n,
        "bound_by": b_by, "library_ms": lib_ms * n, "variant": which,
        "prev_design_ms": prev * n, "profiler_ms": prof * n})
    del q, k, v, band
    torch.cuda.empty_cache()

    # chunked SSD: l (400, 2048) f32, dtx (400, 2048, 64), B/C (400, 2048, 16)
    case = (LM_BATCH * cfg.ssm_heads, LM_PROMPT, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_chunk)
    ins = ssd_inputs(case, bf16, g)
    BH, L, P, S, Q = case
    which = ssd_kernel.variant(bf16, P)
    t = in_turns({
        which: lambda: ssd_kernel.ssd_chunked(*ins, chunk=Q),
        "simt": lambda: ssd_kernel._run_simt(*ins, Q)},
        {which: 20, "simt": 5})
    (ms, prof), (prev, prev_prof) = t[which], t["simt"]
    plain = cuda_time_ms(lambda: ssd_ref.ssd_chunked_ref(*ins, chunk=Q), 3)
    tri = Q * (Q + 1) // 2
    flops = BH * (L // Q) * (2 * Q * P * S          # C . state
                             + 2 * tri * S          # C B^T, lower triangle
                             + 2 * tri * P          # (M o G) dtx
                             + 2 * Q * P * S)       # state increment
    nbytes = BH * L * (4 + 2 * (2 * P + 2 * S))
    b_ms, b_by = bound(nbytes, flops, bf16)
    n = launches["ssd_chunked"]
    # each stage alone; bytes each stage moves (inputs once, outputs once)
    _, _, _, args = ssd_kernel._mma_stages(*ins, Q)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {st: (lambda st=st: ssd_kernel._launch_stage(st, args[st],
                                                         stream))
             for st in ssd_kernel.STAGES}
    nc, st_bytes = L // Q, BH * (L // Q) * (P * S + 1) * 4
    stage_bytes = {"chunk_state": BH * L * (4 + 2 * (P + S)) + st_bytes,
                   "state_pass": BH * nc * (2 * P * S + 1) * 4,
                   "chunk_scan": BH * L * (4 + 2 * (2 * P + 2 * S))
                   + st_bytes - BH * nc * 4}
    stage_ms = {}
    for stage in ssd_kernel.STAGES:
        for prior in ssd_kernel.STAGES[:ssd_kernel.STAGES.index(stage)]:
            calls[prior]()                # the stage's inputs, fresh
        stage_ms[stage] = cuda_time_ms(calls[stage], 50)
    log(f"  ssd_chunked {case} bf16, per call (CUDA events): kernel "
        f"({which}, three launches) {ms:.4f} ms (profiler {prof:.4f} ms), "
        f"the simt design {prev:.4f} ms (profiler {prev_prof:.4f} ms), plain "
        f"{plain:.4f} ms, no library call, bound {b_ms:.4f} ms ({b_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
        f"{nbytes / ms / 1e9:.3f} TB/s achieved ({b_ms / ms:.3f} of the "
        f"bound; simt {nbytes / prev / 1e9:.3f} TB/s)")
    for stage, sms in stage_ms.items():
        log(f"    stage {stage} (CUDA events): {sms:.4f} ms, "
            f"{stage_bytes[stage] / 1e6:.1f} MB moved, "
            f"{stage_bytes[stage] / sms / 1e9:.3f} TB/s")
    rows.append({
        "name": "ssd_chunked", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_mma.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:73",
        "launches": n, "paths": {"serving": {"launches": n}},
        "max_abs_err": errs["ssd_chunked"],
        "ms": ms * n, "plain_ms": plain * n, "bound_ms": b_ms * n,
        "bound_by": b_by, "library_ms": None, "variant": which,
        "prev_design_ms": prev * n, "profiler_ms": prof * n,
        "stage_ms": {k: v * n for k, v in stage_ms.items()}})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lqt_combine import kernel as lqt_kernel
    from repro_torch.kernels.lqt_combine import ref as lqt_ref
    from repro_torch.kernels.lqt_combine import scan as lqt_scan
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import transformer

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    phase("build")
    build_all({"lqt_combine": lqt_kernel.build,
               "lqt_scan": lqt_scan.build,
               **{f"flash_attention {v}": (lambda v=v: fa_kernel.build(v))
                  for v in fa_kernel.VARIANTS},
               **{f"ssd_chunked {v}": (lambda v=v: ssd_kernel.build(v))
                  for v in ssd_kernel.VARIANTS}})

    phase("kernel vs plain version")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    check_lqt(g, lqt_kernel, lqt_ref)
    check_scan(g, lqt_scan, lqt_ref)
    errs = {"flash_attention": check_fa(g, fa_kernel, fa_ref),
            "ssd_chunked": check_ssd(g, ssd_kernel, ssd_ref)}

    phase("estimation path")
    paths, cells = {}, {}
    paths["estimation"], cells["estimation"] = estimation_path(lqt_kernel,
                                                               lqt_scan)
    torch.cuda.empty_cache()

    phase(f"nonlinear path: coordinated turn, {NL_MODE}, {NL_ITERS} "
          f"iterations")
    paths["nonlinear"], cells["nonlinear"] = nonlinear_path(lqt_kernel,
                                                            lqt_scan)
    torch.cuda.empty_cache()

    phase(f"sigma-point path: coordinated turn, {NL_MODE}, {NL_ITERS} "
          f"iterations")
    t0 = time.perf_counter()
    paths["sigma_point"] = sigma_point_path(lqt_kernel, lqt_scan,
                                            cells["nonlinear"])
    torch.cuda.empty_cache()
    phase("ragged path: Wiener velocity, pad-and-bucket")
    paths["ragged"] = ragged_path(lqt_kernel, lqt_scan, cells["estimation"])
    torch.cuda.empty_cache()
    log(f"sigma-point and ragged phases: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase("trajectory engine: the ragged cell's records in waves")
    paths["trajectory_engine"] = trajectory_engine_path(
        lqt_kernel, lqt_scan, cells["estimation"])
    del cells
    torch.cuda.empty_cache()
    phase("streaming engine, linear")
    paths["streaming"] = streaming_linear_path(lqt_kernel, lqt_scan)
    torch.cuda.empty_cache()
    phase("streaming engine, sigma point")
    paths["streaming_sigma_point"] = streaming_sigma_point_path(
        lqt_kernel, lqt_scan)
    torch.cuda.empty_cache()
    log(f"engine phases: {time.perf_counter() - t0:.1f} s")

    phase("lqt_scan timing at the estimation paths' scans")
    kernels = [scan_timing(g, lqt_scan, lqt_ref, paths)]
    torch.cuda.empty_cache()
    phase("lqt_combine timing at the per-level scan's launch shapes")
    kernels.append(combine_timing(
        g, lqt_kernel, lqt_ref,
        {k: paths[k] for k in ("estimation", "nonlinear")}))
    torch.cuda.empty_cache()

    phase(f"serving path: {LM_ARCH}, bfloat16, full width")
    cfg = get_config(LM_ARCH)
    params = transformer.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters ({cfg.param_count() / 1e9:.3f} B "
        f"by the config's count), random weights (seed {SEED})")
    launches = serving_path(cfg, params, fa_kernel, ssd_kernel)
    torch.cuda.empty_cache()

    phase("kernel path vs plain path, float32")
    cross_path(cfg, params)
    torch.cuda.empty_cache()

    phase("LM kernel timing at the serving path's shapes")
    kernels += lm_kernel_timing(cfg, launches, fa_kernel, fa_ref, ssd_kernel,
                                ssd_ref, g, errs)

    phase("report")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
