#!/usr/bin/env python3
"""Measurements behind the design of the whole-scan kernel
(``src/repro_torch/kernels/lqt_combine/csrc/lqt_scan.cu``), on one NVIDIA
card:

    python3 tools/lqt_scan_probe.py

1. layout -- the pairwise one-thread combine (``lqt_combine.cu``) at 65536
   pairs, nx = 4 and 5, float64, on lane-major operands (as the kernel
   takes them) and on natural-layout rows (element l's part at
   ``p + l * part size``, as the scan's input and output are), each read
   through the read-only path and with plain loads;
2. phases -- the scan kernel with a timestamp (``%globaltimer``, block 0)
   at the start of every phase and at the end, at the two estimation
   paths' scans (2049 elements at nx = 4, 513 at nx = 5; one record and
   64), float64, suffix scan.

Variants are built from this checkout's sources by text substitution into
``build/lqt_scan_probe/`` (only nx = 4 and 5, float64), beside the
production libraries.  It needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

CSRC = ROOT / "src/repro_torch/kernels/lqt_combine/csrc"
OUT = ROOT / "build" / "lqt_scan_probe"


def log(msg: str) -> None:
    print(msg, flush=True)


def sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise AssertionError(f"probe: expected {count} x {old[:60]!r}")
    return text.replace(old, new)


def only_nx45_f64(src: str) -> str:
    src = re.sub(r"    case [123678]: .*?\n", "", src)
    return src


def pairwise_variants() -> dict:
    hdr = (CSRC / "lqt_combine.cuh").read_text()
    base = only_nx45_f64((CSRC / "lqt_combine.cu").read_text())
    rows = base
    for side in "12":
        for part, size in (("A", "NX * NX"), ("b", "NX"), ("C", "NX * NX"),
                           ("e", "NX"), ("J", "NX * NX")):
            rows = sub(rows, f"const_cast<T*>({part}{side}) + l",
                       f"const_cast<T*>({part}{side}) + l * {size}")
    rows = sub(rows, "const lqt::Elem<T> o{oA + l, ob + l, oC + l, oe + l, "
               "oJ + l, B};",
               "const lqt::Elem<T> o{oA + l * NX * NX, ob + l * NX, "
               "oC + l * NX * NX, oe + l * NX, oJ + l * NX * NX, 1};")
    rows = rows.replace("l, B};", "l * NX, 1};")   # the operands' stride
    rows = re.sub(r"(const_cast<T\*>\(J[12]\) \+ l \* NX \* NX), B\}",
                  r"\1, 1}", rows)
    if rows.count(", 1}") != 3:
        raise AssertionError("probe: natural-layout strides not set")
    plain = "lqt::combine_thread<NX, T>(x1, x2, o, lqt::Plain{});"
    ldg = "lqt::combine_thread<NX, T>(x1, x2, o, lqt::Lanes{});"
    return {"lane-major, read-only path": (hdr, base),
            "lane-major, plain loads": (hdr, sub(base, ldg, plain)),
            "natural rows, read-only path": (hdr, rows),
            "natural rows, plain loads": (hdr, sub(rows, ldg, plain))}


def stamped_scan() -> tuple:
    hdr = (CSRC / "lqt_combine.cuh").read_text()
    src = only_nx45_f64((CSRC / "lqt_scan.cu").read_text())
    src = sub(src, "namespace cg = cooperative_groups;\n", """\
namespace cg = cooperative_groups;
__device__ long long g_ns[130];
extern "C" int read_stamps(long long* ns) {
  return int(cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns)));
}
__device__ __forceinline__ void stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_ns[i] = t;
  }
}
""")
    src = sub(src, "    started = true;\n    prev_local = local;\n",
              "    started = true;\n    prev_local = local;\n    stamp(p);\n")
    src = sub(src, "      output_copies<NX>(a, rows, copies, base, step);\n"
              "    }\n  }\n}\n",
              "      output_copies<NX>(a, rows, copies, base, step);\n"
              "    }\n  }\n  grid.sync();\n  stamp(128);\n}\n")
    return hdr, src


def build(name: str, hdr: str, src: str):
    from repro_torch.kernels import _build

    d = OUT / name.replace(" ", "_").replace(",", "")
    d.mkdir(parents=True, exist_ok=True)
    (d / "lqt_combine.cuh").write_text(hdr)
    (d / "k.cu").write_text(src)
    lib, info = _build.compile_library("probe_" + d.name, d / "k.cu")
    return lib, info


def graph_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def natural(B: int, nx: int, g) -> tuple:
    def r(*s):
        return torch.randn(*s, generator=g, device="cuda", dtype=torch.float64)

    def psd():
        A = r(B, nx, nx)
        return (A @ A.transpose(-1, -2) / nx
                + 0.1 * torch.eye(nx, device="cuda", dtype=torch.float64))

    return (r(B, nx, nx) * 0.6, r(B, nx), psd(), r(B, nx), psd())


def layout(libs: dict, g) -> None:
    from repro_torch.kernels.lqt_combine.ref import lqt_combine_ref

    B = 65536
    for nx in (4, 5):
        n1, n2 = natural(B, nx, g), natural(B, nx, g)
        want = lqt_combine_ref(*n1, *n2)

        def lanes(xs):
            return tuple((x.permute(1, 2, 0) if x.dim() == 3 else x.T)
                         .contiguous() for x in xs)

        l1, l2 = lanes(n1), lanes(n2)
        for name, lib in libs.items():
            rows = name.startswith("natural")
            ins = (n1 + n2) if rows else (l1 + l2)
            outs = tuple(torch.empty_like(x) for x in ins[:5])
            pin = (ctypes.c_void_p * 10)(*(x.data_ptr() for x in ins))
            pout = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in outs))

            def call():
                err = lib.lqt_combine_launch(
                    1, nx, pin, pout, B, 128,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err

            call()
            torch.cuda.synchronize()
            got = outs if rows else tuple(
                x.permute(2, 0, 1) if x.dim() == 3 else x.T for x in outs)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            log(f"layout: pairwise combine, nx={nx}, {B} pairs, {name}: "
                f"{graph_ms(call, 50):.5f} ms (CUDA events, graph replay), "
                f"max abs err vs plain {err:.2e}")


def phases(lib, g) -> None:
    from repro_torch.core.types import LQTElement
    from repro_torch.kernels.lqt_combine import ref, scan

    lib.read_stamps.argtypes = [ctypes.c_void_p]
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    i64s = ctypes.POINTER(ctypes.c_int64)
    fn = lib.lqt_scan_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ptrs, i64s, ptrs, i64s, ptrs,
                   ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    scan.build()
    prod = scan._lib
    for n, R, nx in ((2049, 1, 4), (2049, 64, 4), (513, 1, 5), (513, 64, 5)):
        sh = (n,) if R == 1 else (n, R)
        e = LQTElement(*(x.reshape(sh + x.shape[1:])
                         for x in natural(n * R, nx, g)))
        scan._lib = lib
        got = scan.lqt_scan(e, reverse=True)
        for _ in range(3):
            scan.lqt_scan(e, reverse=True)
        torch.cuda.synchronize()
        scan._lib = prod
        want = ref.lqt_scan_ref(e, reverse=True)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ns = (ctypes.c_longlong * 130)()
        lib.read_stamps(ns)
        L = n.bit_length() - 1
        rows = []
        for p in range(2 * L):
            down = p < L
            l = p if down else 2 * L - 1 - p
            W = (n >> (l + 1)) * R if down else (((n >> l) - 1) // 2) * R
            if W or (not down and l == 0):
                rows.append((p, "down" if down else "up", l, W))
        t = [ns[p] for p, *_ in rows] + [ns[128]]
        log(f"phases: scan of {n} x {R} records, nx={nx} (max abs err vs "
            f"plain {err:.2e}), {(t[-1] - t[0]) / 1e3:.3f} us from the first "
            f"phase to the end:")
        for (p, kind, l, W), a, b in zip(rows, t, t[1:]):
            log(f"  phase {p:2d} {kind:4s} level {l:2d}, {W:6d} combines: "
                f"{(b - a) / 1e3:8.3f} us")


def main() -> int:
    if not torch.cuda.is_available():
        print("lqt_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    jobs = dict(pairwise_variants())
    jobs["scan with phase stamps"] = stamped_scan()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(build, k, *v) for k, v in jobs.items()}
        libs = {k: f.result()[0] for k, f in futs.items()}
    for k, lib in libs.items():
        if k.startswith(("lane", "natural")):
            fn = lib.lqt_combine_launch
            fn.argtypes = [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_void_p),
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(0)
    layout({k: v for k, v in libs.items() if k != "scan with phase stamps"},
           g)
    phases(libs["scan with phase stamps"], g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
