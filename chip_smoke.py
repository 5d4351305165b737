#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run on any miss:

1. build   -- compile the CUDA kernels from the sources in this checkout
              (``nvcc`` for ``sm_90a`` into ``build/``), with ptxas's
              register and spill counts;
2. kernels -- each kernel against its plain PyTorch version on the card,
              on random element pairs with PSD C/J, nx in {2, 4, 8}, lane
              counts {1, 7, 4097, 2**20}, float32 and float64; then the
              whole-scan kernel driver against the plain suffix scan;
3. main    -- ``Estimator(method="parallel_kernel").solve`` on the Wiener
              velocity model (paper section 5.1) at T = 2048 blocks x
              nsub = 10 (N = 20480) in float64, for one record and for 64
              stacked records, held against the port's ``parallel_rts`` on
              the card and its ``sequential_rts`` on the CPU (a labelled
              reference), with the launch counts of the kernels, then the
              median solve time over a few runs, and one profiled solve
              per cell (device busy time, top device kernels);
4. report  -- one JSON line of per-kernel numbers, the card's name and
              power limit, and the final status line.

It needs a CUDA card: without one it exits non-zero and prints no result.
It imports only the port, never the JAX reference package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM peaks: HBM3 rate and the non-tensor-core float rates (NVIDIA
# data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

N_BLOCKS, NSUB, RECORDS = 2048, 10, 64
SEED = 0
# kernel vs plain version: normwise relative error bound per dtype.  The
# unpivoted Gauss-Jordan and the pivoted solve differ by round-off times
# the conditioning of M = I + C1 J2 (at most a few hundred for these
# operands), so float64 stays far below 1e-10 and float32 below 1e-3.
KERNEL_RTOL = {torch.float64: 1e-10, torch.float32: 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    torch.cuda.synchronize()
    log(f"== {name}")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.wiener_velocity import WienerVelocityConfig
    from repro_torch.core import (
        Estimator,
        KernelOptions,
        ParallelOptions,
        Problem,
        SequentialOptions,
        simulate_linear,
        suffix_scan,
        time_grid,
    )
    from repro_torch.core.combine import lqt_combine
    from repro_torch.core.types import LQTElement
    from repro_torch.kernels.lqt_combine import kernel as lqt_kernel
    from repro_torch.kernels.lqt_combine import ref as lqt_ref
    from repro_torch.kernels.lqt_combine.ops import kernel_suffix_scan

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    # -- 1. build ---------------------------------------------------------
    phase("build")
    info = lqt_kernel.build()
    log(f"lqt_combine: built in {info['seconds']:.1f} s "
        f"(cached={info['cached']}) -> {info['library']}")
    for row in info["ptxas"]:
        log(f"  ptxas lqt_combine nx={row['nx']} {row['dtype']}: "
            f"{row.get('registers')} registers, "
            f"{row.get('spill_stores')} B spill stores, "
            f"{row.get('spill_loads')} B spill loads")

    # -- 2. kernel vs plain version --------------------------------------
    phase("kernel vs plain version")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.float64):
        for nx in (2, 4, 8):
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

    # -- 3. main path -----------------------------------------------------
    phase("main path")
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
    sols = {k: est_k.solve(p) for k, p in problems.items()}
    torch.cuda.synchronize()
    launches = lqt_kernel.launch_count()
    log(f"main path launches: lqt_combine {launches}")
    if launches <= 0:
        raise AssertionError("the main path did not launch lqt_combine")

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
            est.solve(p)                                      # warm-up
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                est.solve(p)
                stop.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(stop))
            solve_ms[(name, label)] = statistics.median(times)
            log(f"  solve {name} {label}: median {solve_ms[(name, label)]:.3f}"
                f" ms over 5 runs (CUDA events, after one warm-up)")

    # -- where the time goes: one profiled solve per cell -----------------
    phase("profile")
    from torch.profiler import ProfilerActivity, profile

    for name, p in problems.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            est_k.solve(p)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        count = sum(e.count for e in kern)
        solve = solve_ms[(name, "parallel_kernel")]
        log(f"  {name} parallel_kernel: {count} device kernels, device busy "
            f"{busy:.3f} ms of a {solve:.3f} ms solve (idle share "
            f"{max(0.0, 1 - busy / solve):.3f})")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                f"x{e.count:<5d} {e.key[:90]}")

    # -- kernel timing at the main path's launch shapes -------------------
    phase("kernel timing at the main path's shapes")
    shapes = (scan_lane_counts(n_elems, 1)
              + scan_lane_counts(n_elems, RECORDS))
    if len(shapes) != launches:
        raise AssertionError(f"expected {len(shapes)} launches on the "
                             f"main path, counted {launches}")
    # Device time from the profiler (what the card spends in the kernels);
    # wall time from CUDA events around back-to-back calls (what a caller
    # waits, host launch overhead included).
    k_dev = p_dev = k_wall = p_wall = bytes_ = flops = max_abs = 0.0
    for B in sorted(set(shapes)):
        mult = shapes.count(B)
        ops1, ops2 = random_pairs(4, B, torch.float64, g)
        got = lqt_kernel.lqt_combine_lanes(ops1, ops2)
        want = lqt_ref.lqt_combine_lanes_ref(ops1, ops2)
        max_abs = max(max_abs, compare(got, want)[0])

        def kern():
            return lqt_kernel.lqt_combine_lanes(ops1, ops2)

        def plain():
            return lqt_ref.lqt_combine_lanes_ref(ops1, ops2)

        k_dev += mult * device_time_ms(kern, 20)
        p_dev += mult * device_time_ms(plain, 5)
        k_wall += mult * cuda_time_ms(kern, 50)
        p_wall += mult * cuda_time_ms(plain, 10)
        bytes_ += mult * B * combine_bytes(4, 8)
        flops += mult * B * combine_flops(4)
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / PEAK_FLOPS[torch.float64] * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    log(f"  {len(shapes)} launches, lanes per launch {sorted(shapes)}")
    log(f"  summed over the launches of one single + one {RECORDS}-record "
        f"solve: kernel device {k_dev:.4f} ms (wall {k_wall:.4f} ms), plain "
        f"version device {p_dev:.4f} ms (wall {p_wall:.4f} ms), bound "
        f"{bound_ms:.5f} ms ({bound_bytes_ms:.5f} ms for {bytes_:.0f} B, "
        f"{bound_ops_ms:.5f} ms for {flops:.0f} FLOP)")
    for B in (max(shapes), 1024, 1):
        ops1, ops2 = random_pairs(4, B, torch.float64, g)
        dev = device_time_ms(
            lambda: lqt_kernel.lqt_combine_lanes(ops1, ops2), 50)
        wall = cuda_time_ms(
            lambda: lqt_kernel.lqt_combine_lanes(ops1, ops2), 100)
        nbytes = B * combine_bytes(4, 8)
        log(f"  one launch, B={B} lanes: device {dev:.5f} ms, wall "
            f"{wall:.5f} ms per launch, bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
            f"({nbytes / dev / 1e9:.3f} TB/s achieved)")

    # -- 4. report --------------------------------------------------------
    phase("report")
    kernels = [{
        "name": "lqt_combine",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lqt_combine/csrc/lqt_combine.cu",
        "replaces": "src/repro/kernels/lqt_combine/kernel.py:115",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_dev,
        "plain_ms": p_dev,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms
        else "operations",
        "library_ms": None,
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
