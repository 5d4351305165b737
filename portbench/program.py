"""The system under test, built from a configuration file: the port's
model (its class and, for a nonlinear model, its drift and measurement
functions from the module that ``program`` names; every matrix from the
file) behind ``repro_torch.serving.TrajectoryEngine``."""
from __future__ import annotations

import dataclasses
import importlib

MATRICES = ("F", "c", "H", "r", "Q", "R", "m0", "P0")


def build_model(cfg: dict, dtype: str, device):
    import torch

    dt = getattr(torch, dtype)
    base = importlib.import_module(cfg["program"]).config().model(
        dtype=dt, device=device)
    names = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{
        k: torch.tensor(cfg[k], dtype=dt, device=device)
        for k in MATRICES if k in cfg and k in names})


def solver_options(cfg: dict):
    from repro_torch.core import IteratedOptions
    from repro_torch.core.registry import get_method

    inner = get_method(cfg["method"]).options_cls(**cfg["options"])
    if not cfg.get("iterations"):
        return inner
    return IteratedOptions(inner=inner, iterations=int(cfg["iterations"]))


def build_engine(cfg: dict, batch: int, dtype: str, device):
    from repro_torch.serving import TrajectoryEngine

    return TrajectoryEngine(build_model(cfg, dtype, device), batch=batch,
                            method=cfg["method"],
                            options=solver_options(cfg), device=device)
