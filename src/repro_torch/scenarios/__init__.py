"""Named FHP scenarios: geometry + density + forcing + seed +
observables, one registry for examples, tests and the chip smoke run."""
from repro_torch.scenarios import observables  # noqa: F401  (re-export)
from repro_torch.scenarios.base import Scenario
from repro_torch.scenarios.registry import get, names, register
import repro_torch.scenarios.library  # noqa: E402,F401  (fills the registry)

__all__ = ["Scenario", "get", "names", "register", "observables"]
