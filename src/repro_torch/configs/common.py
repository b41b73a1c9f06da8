"""Config framework: the ArchSpec record of an architecture (its published
configuration and a tiny same-family config for CPU smoke runs)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    model_cfg: object
    reduced_cfg: object  # tiny same-family config for CPU smoke tests
    source: str  # citation tag from the assignment
    notes: str = ""
