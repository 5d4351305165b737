"""Configs: the paper's estimation experiments (section 5) and the
language-model architectures ported so far.

Every architecture module exposes ``config()`` (the published
configuration) and ``smoke_config()`` (a reduced configuration of the same
family for CPU tests); both are registered with
``repro_torch.config.register_config``, the latter under ``<name>-smoke``.
"""
from repro_torch.config import register_config

from . import hymba_1_5b

ARCHS = ("hymba-1.5b",)

_MODULES = {"hymba-1.5b": hymba_1_5b}

for _name, _mod in _MODULES.items():
    register_config(_name, _mod.config)
    register_config(_name + "-smoke", _mod.smoke_config)
