"""A configuration's model adapters: one module of ``benchmark/adapters``
per model kind, found by name as a traffic file's driver and a per-layer
metric's reader are.

A configuration may name the module of a role (``act3d``, the keypose
model; ``planner``, the trajectory DDPM) under ``"adapters"``, as in
``"adapters": {"planner": "<module>"}``; a role it does not name takes
the module of the same name.  An adapter builds the system's model and
its plain reference from one seeded state dict, draws the training
batches, gives the Trainer's loss and the reference's, records the
system's discrete choices for the reference to follow, and lists the
attention sites.  It states the constructor options its reference
implements (``OPTIONS``): a configuration asking for another value is
refused here, before any step, rather than compared against a different
model.
"""

from __future__ import annotations

import importlib
from typing import Dict


def adapter(cfg: Dict, kind: str):
    """The adapter module of role ``kind`` (a missing one raises
    ``ModuleNotFoundError`` naming it), the configuration's section of that
    role checked against its ``OPTIONS``."""
    name = cfg.get("adapters", {}).get(kind, kind)
    module = importlib.import_module(f"{__package__}.adapters.{name}")
    section = cfg[kind]
    for key, want in module.OPTIONS.items():
        if section.get(key) != want:
            raise ValueError(f"{kind}: the reference implements {key}={want!r}, the "
                             f"configuration states {section.get(key)!r}")
    return module


def program(kind: str, cfg: Dict, seed: int, device):
    """The system's model of role ``kind`` with the seeded weights (the
    entry ``scripts/profile_torch_spans.py`` builds its models through)."""
    return adapter(cfg, kind).program(cfg, seed, device)
