"""The one traffic generator: a pool of records drawn from the seed, and
the closed loop of clients that cycles through it.

A mix (``traffic/<name>.json``) is data only:

    {"wave": 64,            rows of the engine's fixed-size waves
     "in_flight": 128,      a closed loop: records outstanding, a new one
                            submitted as each one's trajectory reaches the
                            host
     "arrivals": {"rate": 180},   or an open loop: records arrive as a
                            Poisson stream of this many a second
     "pool": 512,           distinct records, cycled in order
     "lengths": {"dist": "fixed", "intervals": 20480}
             or {"dist": "loguniform", "min": 2560, "max": 20480}}

Every seed gets the same lengths and the same gaps between arrivals:
``fixed`` is one length, ``loguniform`` the pool's quantiles of the
log-uniform law, the gaps the quantiles of the exponential law over the
window, each put in an order drawn from the seed.  The measurements are the configuration's simulator's draws from
a ``torch.Generator`` seeded with the seed, on the run's device.  Records
are submitted from host NumPy, as a client would.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, List, Tuple

import numpy as np


def no_label(name: str):
    return contextlib.nullcontext()


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator of the seed (any whole number) and a stream."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def pool_lengths(mix: dict, seed: int) -> np.ndarray:
    spec, n = mix["lengths"], int(mix["pool"])
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["intervals"]))
    if spec["dist"] == "loguniform":
        q = (np.arange(n) + 0.5) / n
        lo, hi = float(spec["min"]), float(spec["max"])
        lengths = np.rint(lo * (hi / lo) ** q).astype(int)
        return seed_rng(seed, 0).permutation(lengths)
    raise ValueError(f"unknown length law {spec['dist']!r}")


class Pool:
    """The mix's records: ``lengths`` ``(pool,)`` and measurements ``y``
    ``(pool, max length, ny)`` (host float64) on one time grid."""

    def __init__(self, cfg: dict, reference, mix: dict, seed: int, device):
        import torch

        self.lengths = pool_lengths(mix, seed)
        gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        self.y = reference.simulate(cfg, self.lengths, gen)
        self.ts = cfg["t0"] + cfg["dt"] * np.arange(self.y.shape[1] + 1)

    def __len__(self) -> int:
        return len(self.lengths)

    def record(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        n = int(self.lengths[i])
        return self.ts[:n + 1], self.y[i, :n]


def warm_up(engine, pool: Pool, rounds: int = 2) -> List[int]:
    """``rounds`` full waves of every bucket that the pool's lengths fall
    into (the engine's own bucketing), results copied to the host and
    dropped; returns the padded lengths warmed."""
    from repro_torch.core.padding import bucket_length

    buckets = {}
    for i, n in enumerate(pool.lengths):
        key = bucket_length(int(n), engine.estimator.block_size,
                            engine.bucket_sizes)
        buckets.setdefault(key, []).append(i)
    for idx in buckets.values():
        for _ in range(rounds):
            for j in range(engine.batch):
                engine.submit(*pool.record(idx[j % len(idx)]))
            engine.step()
            for _, sol in engine.collect():
                sol.x.cpu()
    return sorted(buckets)


class Clients:
    """The closed loop: ``in_flight`` records outstanding, each one's
    latency from just before ``submit`` to its trajectory on the host.

    Completed trajectories pass through a reservoir sample of ``sample``
    records drawn from the seed, kept for the comparison with the
    reference; the rest are dropped once copied.
    """

    def __init__(self, engine, pool: Pool, in_flight: int, sample: int,
                 seed: int):
        self.engine, self.pool, self.in_flight = engine, pool, in_flight
        self.sample = sample
        self.rng = seed_rng(seed, 1)
        self.next = 0
        self.open = {}                 # ticket -> (pool index, submit time)
        self.done: List[Tuple[float, float]] = []   # (done time, latency)
        self.finished: List[int] = []  # pool index of each, in order
        self.kept: List[Tuple[int, np.ndarray]] = []
        self.seen = 0
        self.wave_ends: List[float] = []
        self.label: Callable = no_label

    def start(self, t0: float) -> None:
        """The window opens at ``t0`` (``perf_counter``)."""

    def fill(self) -> None:
        with self.label("portbench.submit"):
            while len(self.open) < self.in_flight:
                i = self.next % len(self.pool)
                self.next += 1
                ts, y = self.pool.record(i)
                t = time.perf_counter()
                self.open[self.engine.submit(ts, y)] = (i, t)

    def wave(self) -> int:
        """One engine wave; returns the records it completed."""
        with self.label("portbench.step"):
            self.engine.step()
        with self.label("portbench.collect"):
            got = self.engine.collect()
            for ticket, sol in got:
                x = sol.x.cpu().numpy()
                t = time.perf_counter()
                i, t_sub = self.open.pop(ticket)
                self.done.append((t, t - t_sub))
                self.finished.append(i)
                self._keep(i, x)
        self.wave_ends.append(time.perf_counter())
        return len(got)

    def _keep(self, i: int, x: np.ndarray) -> None:
        self.seen += 1
        if len(self.kept) < self.sample:
            self.kept.append((i, x))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.sample:
            self.kept[j] = (i, x)


class OpenClients(Clients):
    """The open loop: records arrive on a schedule, whether or not earlier
    ones have finished, and each one's latency runs from when it was due
    (so a stall counts against every record it delays).  Arrivals are
    submitted between waves; ``late`` is the most the generator ran behind
    the schedule."""

    def __init__(self, engine, pool: Pool, rate: float, seconds: float,
                 sample: int, seed: int):
        super().__init__(engine, pool, 0, sample, seed)
        n = max(1, round(rate * seconds))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        self.due = np.cumsum(seed_rng(seed, 2).permutation(gaps))
        self.t0 = 0.0
        self.late = 0.0

    def start(self, t0: float) -> None:
        self.t0 = t0

    def wave(self) -> int:
        """One engine wave of what has arrived; 0 at once if nothing has."""
        return super().wave() if self.engine.pending() else 0

    def fill(self) -> None:
        with self.label("portbench.submit"):
            now = time.perf_counter() - self.t0
            while self.next < len(self.due) and self.due[self.next] <= now:
                i = self.next % len(self.pool)
                due = self.t0 + self.due[self.next]
                self.next += 1
                self.open[self.engine.submit(*self.pool.record(i))] = (i, due)
                self.late = max(self.late, time.perf_counter() - due)


def clients(engine, pool: Pool, mix: dict, sample: int, seed: int,
            seconds: float) -> Clients:
    """The mix's loop: open where it gives arrivals, else closed."""
    if "arrivals" in mix:
        return OpenClients(engine, pool, float(mix["arrivals"]["rate"]),
                           seconds, sample, seed)
    return Clients(engine, pool, int(mix["in_flight"]), sample, seed)
