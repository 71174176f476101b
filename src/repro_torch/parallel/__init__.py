"""Sharding rules: logical axes to mesh axes, and the ambient rules
context (see :mod:`repro_torch.parallel.rules`)."""
from repro_torch.parallel.rules import (DEFAULT_RULES, Rules,  # noqa: F401
                                        sharding_for, spec_for,
                                        tree_shardings, tree_specs)
