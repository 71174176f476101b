"""Scenario registry: named builders, scalable at fetch time.

    from repro_torch import scenarios
    sc = scenarios.get("cylinder", height=32, width=256)   # scaled
    for name in scenarios.names(): ...                     # sweep
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.scenarios.base import Scenario

_REGISTRY: Dict[str, Callable[..., Scenario]] = {}


def register(name: str):
    """Decorator: register a Scenario builder under ``name``.  Builders
    take keyword overrides (height, width, ...) and return a Scenario."""
    def deco(builder: Callable[..., Scenario]):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = builder
        return builder
    return deco


def get(name: str, **overrides) -> Scenario:
    """Build the named scenario, passing ``overrides`` to its builder
    (commonly ``height=``/``width=`` to scale it)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)


def names() -> List[str]:
    return sorted(_REGISTRY)
