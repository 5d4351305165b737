"""One run of one cell: set-up, the measured window, the drain, the
comparison with the plain reference, and the result.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json`` -- the model's numbers, dtype, method and
  options (:mod:`program` builds the port's engine from it);
* ``reference/<config>.py`` -- its plain simulator and reference solve;
* ``traffic/<traffic>.json`` -- the mix, read by :mod:`traffic`;
* ``workloads/<cell>.json`` -- the comparison's sample and limits, and
  ``small``, the cell's mix cut to a size the CPU tests hold;
* ``metrics/<metric>.py`` -- ``read(ctx)``, the metric from what the run
  recorded, or ``None`` where it finds nothing to read.

A traced run (``trace``) turns on the port's telemetry for the window,
keeps each wave's ``engine.step`` span tree, and profiles a steady
stretch of waves with ``torch.profiler``, with telemetry off so that the
stretch runs the untraced path, recording the solves' shapes and the
records completed there.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path
from typing import Optional

import numpy as np

from portbench import check, profiling, traffic

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names the measured process must not hold: JAX and the
# JAX package (compared whole: ``repro_torch`` is the port)
BANNED = ("jax", "jaxlib", "flax", "repro")
STRETCH_START = 0.3          # share of the window before the profiled stretch
STRETCH_SECONDS = 2.0        # its length, at most 0.3 of the window
DRAIN_SECONDS = 60.0


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def load_file(path: Path):
    """Import a file of the benchmark by its path (names may hold ``-``
    and ``.``)."""
    name = "portbench_" + "".join(c if c.isalnum() else "_"
                                  for c in str(path.relative_to(ROOT)))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config: str):
    return load_file(ROOT / "reference" / f"{config}.py")


def reader(metric: str):
    return load_file(ROOT / "metrics" / f"{metric}.py").read


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry {name!r}")


def cell_metrics(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


class Tracer:
    """The traced run's recording: telemetry on, the ``engine.step`` span
    tree of each wave outside the profiled stretch, and one profiled
    stretch of whole waves from ``STRETCH_START`` of the window on, with
    the shape of each solve and the pool index of each record completed
    inside it.  Telemetry is off for the stretch: with it on, each solve
    waits for the card and reads its results back (the estimator's
    measured path), which the untraced runs never do.  The port's
    cumulative counters therefore leave the stretch's waves out.  The
    stretch's events are read after the window has closed."""

    def __init__(self, engine, seconds: float, cuda: bool):
        import torch
        from repro_torch import obs
        from repro_torch.obs import tracing

        self.torch, self.obs, self.tracing, self.cuda = torch, obs, tracing, cuda
        self.start = STRETCH_START * seconds
        self.stop = self.start + min(STRETCH_SECONDS, STRETCH_START * seconds)
        self.spans, self.solves, self.records = [], [], []
        self.prof, self.state = None, "before"   # -> "in" -> "after"
        est = engine.estimator
        solve = est.solve

        def recorded(problem):
            if self.state == "in":
                self.solves.append(tuple(problem.y.shape))
            return solve(problem)

        est.solve = recorded
        # the profiler's first start initialises its tracer (seconds):
        # pay that here, in set-up, and not inside the stretch
        from torch.profiler import ProfilerActivity, profile

        self.activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=self.activities):
            torch.ones(1, device=engine.estimator.device).add_(1)
            self._sync()
        obs.enable()
        obs.reset()

    @contextlib.contextmanager
    def wave(self, elapsed: float, clients):
        if self.state == "after" or elapsed < self.start:
            yield
            return
        torch = self.torch
        if self.state == "before":
            self._sync()
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
            clients.label = torch.profiler.record_function
            self.obs.disable()
            self.state = "in"
        done = len(clients.finished)
        with torch.profiler.record_function(profiling.MARKER):
            yield
        self.records.extend(clients.finished[done:])
        if elapsed >= self.stop:
            self.finish(clients)

    def finish(self, clients) -> None:
        """End the profiled stretch, if one is running."""
        if self.state == "in":
            self._sync()
            self.prof.stop()
            clients.label = traffic.no_label
            self.obs.enable()
            self.state = "after"

    def after_wave(self) -> None:
        # the stretch's waves leave no span: telemetry is off there
        self.spans.extend(t for t in self.obs.span_trees()
                          if t["name"] == "engine.step")
        self.tracing.reset()

    def profile(self) -> Optional[profiling.Profile]:
        if self.prof is None:
            return None
        return profiling.Profile.from_profiler(self.prof)

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, traffic_over: Optional[dict] = None,
             check_over: Optional[dict] = None, dtype: Optional[str] = None,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """Run ``cell`` once and return its result (the last line's object).

    ``device``, ``traffic_over`` (keys of the mix), ``check_over`` (keys of
    the cell's check) and ``dtype`` exist for the tests and the control
    runs; the benchmark's command passes none of them.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    entry = find(bench["workloads"], cell)
    cfg = load_json(ROOT / "configs" / f"{entry['config']}.json")
    mix = {**load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
           **(traffic_over or {})}
    chk = {**load_json(ROOT / "workloads" / f"{cell}.json")["check"],
           **(check_over or {})}
    ref = reference(entry["config"])

    import torch
    from portbench import program

    cuda = torch.device(device).type == "cuda"
    engine = program.build_engine(cfg, int(mix["wave"]), dtype or cfg["dtype"],
                                  device)
    pool = traffic.Pool(cfg, ref, mix, seed, device)
    buckets = traffic.warm_up(engine, pool)
    clients = traffic.clients(engine, pool, mix, int(chk["sample"]), seed,
                              seconds)
    tracer = Tracer(engine, seconds, cuda) if trace else None
    if cuda:
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    clients.start(t0)
    clients.fill()
    while (now := time.perf_counter()) < t_end:
        with (tracer.wave(now - t0, clients) if tracer
              else contextlib.nullcontext()):
            clients.wave()
            clients.fill()
        if tracer:
            tracer.after_wave()
    if tracer:
        tracer.finish(clients)
    attempted = clients.next
    in_window = [lat for t, lat in clients.done if t <= t_end]
    # every answer due is waited for, a minute past the close at most; one
    # that never comes is a failure
    deadline = time.perf_counter() + DRAIN_SECONDS
    while clients.open and time.perf_counter() < deadline:
        if clients.wave() == 0 and not clients.engine.pending():
            break
    failed = len(clients.open)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if tracer:
        counters = tracer.obs.snapshot()
        tracer.obs.disable()
        profile = tracer.profile()
    del engine, clients.engine               # the program's state, freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    waves = np.diff([t0] + [t for t in clients.wave_ends if t <= t_end])
    q1, q2, q3 = np.percentile(waves, [25, 50, 75]) * 1e3 if waves.size else (
        (math.nan,) * 3)
    log(f"{cell}: seed {seed}, buckets {buckets}, {len(in_window)} records "
        f"in {seconds} s, set-up {setup_s:.3f} s, median wave {q2:.3f} ms "
        f"(quartiles {q1:.3f}-{q3:.3f})"
        + (f", arrivals up to {clients.late * 1e3:.1f} ms late"
           if isinstance(clients, traffic.OpenClients) else ""))

    ctx = types.SimpleNamespace(
        cell=entry, config=cfg, traffic=mix, window_s=float(seconds),
        setup_s=setup_s, latencies_s=np.array(in_window),
        completed=len(in_window),
        spans=tracer.spans if tracer else [],
        counters=counters if tracer else {},
        profile=profile if tracer else None,
        solves=tracer.solves if tracer else [],
        record_lengths=(pool.lengths[tracer.records].tolist() if tracer
                        else []),
        ny=int(pool.y.shape[2]),
        itemsize=torch.finfo(getattr(torch, dtype or cfg["dtype"])).bits // 8)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, section, cell):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    gap = check.x_gap(cfg, ref, pool, clients.kept)
    limit = float(chk["limits"]["x_gap"])
    correct = bool(gap <= limit and failed == 0)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tracer and profile is not None:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.top_ops(),
                               "idle_gaps": profile.idle_gaps()}
    result["checks"] = {"x_gap": {
        "value": gap if math.isfinite(gap) else None, "limit": limit}}
    return result
