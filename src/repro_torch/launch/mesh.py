"""Production mesh construction and the card's peak rates (the reference's
``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION, not a module-level constant, so
importing this module creates no process group and touches no device: the
dry run starts its own (fake) process group first and builds the mesh over
it, while everything else in the port never sees one.

The constants keep the reference's three names, so a roofline reader takes
either module unchanged, and add the rates the port's bounds use.  Source:
NVIDIA H100 SXM5 data sheet (dense rates, no sparsity, at its 700 W limit);
checked against the card ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints as "NVIDIA H100 80GB HBM3, 700.00 W"
(``chip_smoke.py`` measures the bf16 matmul and copy rates as shares of
them on every run).
"""
from __future__ import annotations

from repro_torch.distributed.policies import MULTI_POD, SINGLE_POD


def make_mesh(shape: tuple, axes: tuple):
    """A host ``DeviceMesh`` of ``shape`` named ``axes`` over the process
    group the caller has started (its world size must be the product of
    ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``: the reference's shapes and axis names
    (``policies.SINGLE_POD`` / ``MULTI_POD``)."""
    m = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(m.sizes, m.axis_names)


# NVIDIA H100 SXM5 hardware constants used by the roofline analysis
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
# bytes/s per card across nodes: one 400 Gb/s NDR NIC a GPU.  A 16-wide mesh
# axis spans two 8-GPU nodes, so its collectives run at the network's rate.
ICI_BW = 50e9
NVLINK_BW = 450e9  # bytes/s per card and direction inside a node (NVLink 4)
FP32_FLOPS = 67e12  # fp32 FLOP/s on the CUDA cores (TF32 is off in the port)
INT_OPS = 67e12  # 32-bit integer ops/s on the CUDA cores, same rate as fp32
