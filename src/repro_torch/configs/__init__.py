"""Configs: the paper's estimation experiments (section 5) and the ten
language-model architectures of the model zoo.

Every architecture module exposes ``config()`` (the published
configuration) and ``smoke_config()`` (a reduced configuration of the same
family for CPU tests); both are registered with
``repro_torch.config.register_config``, the latter under ``<name>-smoke``.
``ARCHS`` lists the architectures in the reference package's order.
"""
from repro_torch.config import register_config

from . import (
    coordinated_turn,
    granite_moe_3b,
    h2o_danube_1_8b,
    hubert_xlarge,
    hymba_1_5b,
    llava_next_34b,
    mamba2_370m,
    phi35_moe_42b,
    qwen3_4b,
    smollm_135m,
    starcoder2_15b,
    wiener_velocity,
)

ARCHS = (
    "hubert-xlarge",
    "mamba2-370m",
    "llava-next-34b",
    "hymba-1.5b",
    "smollm-135m",
    "qwen3-4b",
    "h2o-danube-1.8b",
    "starcoder2-15b",
    "phi3.5-moe-42b-a6.6b",
    "granite-moe-3b-a800m",
)

_MODULES = {
    "hubert-xlarge": hubert_xlarge,
    "mamba2-370m": mamba2_370m,
    "llava-next-34b": llava_next_34b,
    "hymba-1.5b": hymba_1_5b,
    "smollm-135m": smollm_135m,
    "qwen3-4b": qwen3_4b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "starcoder2-15b": starcoder2_15b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "granite-moe-3b-a800m": granite_moe_3b,
}

for _name, _mod in _MODULES.items():
    register_config(_name, _mod.config)
    register_config(_name + "-smoke", _mod.smoke_config)


def arch_module(name: str):
    """The module of architecture ``name`` (a name of ``ARCHS``)."""
    return _MODULES[name]
