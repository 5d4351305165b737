"""Shared model building blocks: parameter specs, norms, RoPE.

Parameters are plain nested dicts of tensors with the reference's names
and layouts.  Every module defines its parameters once as a ``spec``
(shape + logical axes + init) from which both the initialised tree and the
logical-axes tree are derived, so the sharding metadata cannot drift from
the parameters: ``params_axes`` feeds the rules of
``repro_torch.distributed.sharding``, whose shardings the executor of
``repro_torch.distributed.spmd`` runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter: shape, logical axes, init ('normal'|'zeros'|'ones'),
    fan_in (for 1/sqrt(fan_in) scaling; None -> first dim)."""
    shape: tuple
    axes: tuple
    init: str = "normal"
    fan_in: Optional[int] = None


def map_spec(fn: Callable[[P], object], spec: dict) -> dict:
    """Apply ``fn`` to every ``P`` leaf of a nested dict, keys in sorted
    order (the reference's tree order)."""
    return {k: (map_spec(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in sorted(spec.items())}


def init_params(generator: torch.Generator, spec: dict, dtype,
                device=None) -> dict:
    """Normal(0, 1/fan_in) weights drawn in float32 from ``generator``,
    then cast; zeros/ones as the spec says.  The distribution is the
    reference's; the bits are not (``jax.random`` and ``torch.Generator``
    differ).  ``device`` defaults to the generator's."""
    device = generator.device if device is None else device

    def mk(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        fan = p.fan_in if p.fan_in is not None else p.shape[0]
        scale = 1.0 / math.sqrt(max(fan, 1))
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    return map_spec(mk, spec)


def params_axes(spec: dict) -> dict:
    return map_spec(lambda p: p.axes, spec)


def params_shapes(spec: dict) -> dict:
    return map_spec(lambda p: p.shape, spec)


def stack_specs(spec: dict, num: int) -> dict:
    """Prepend a stacked 'layers' axis (weights stacked over layers)."""
    return map_spec(
        lambda p: P((num,) + p.shape, ("layers",) + p.axes, p.init,
                    p.fan_in if p.fan_in is not None else p.shape[0]),
        spec)


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked over layers (views, no copies)."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def rope_freqs(positions, head_dim: int, theta: float):
    """positions: (...,) -> cos, sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., L, H, D); cos/sin: (L, D//2) or broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :] if x.dim() == cos.dim() + 2 else cos
    s = sin[..., None, :] if x.dim() == sin.dim() + 2 else sin
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]
