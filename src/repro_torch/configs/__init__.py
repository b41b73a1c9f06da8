"""Architecture registry of the port: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_7b, deepseek_coder_33b, granite_moe_1b, grok_1_314b, starcoder2_3b,
)
from repro_torch.configs.common import ArchSpec

REGISTRY = {
    spec.arch_id: spec
    for spec in [
        starcoder2_3b.CONFIG, deepseek_7b.CONFIG, deepseek_coder_33b.CONFIG,
        grok_1_314b.CONFIG, granite_moe_1b.CONFIG,
    ]
}

ARCH_IDS = sorted(REGISTRY)


def get_config(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
    return REGISTRY[arch_id]
