"""Production mesh builders and the roofline's per-GPU constants (reference:
``repro.launch.mesh``). Functions, not module-level meshes: importing this
module starts no process group.

The meshes keep the reference's axis names and sizes, ``(data=16,
model=16)`` and ``(pod=2, data=16, model=16)``, so that each dry-run report
sits beside the reference's and the specs compare on the production mesh
itself. They are built over the default process group: on H100 nodes, or
in the dry-run over the ``fake`` backend's 256 or 512 ranks.
"""
from __future__ import annotations

import math


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks; multi-pod adds a leading pod=2 axis (512), over
    the default process group, which must hold at least that many ranks.
    A CUDA mesh, as on H100s, also over the fake backend: DTensor then
    lowers its redistributions as it would there (a CPU mesh turns an
    all-to-all into an all-gather for Gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}; the dry-run "
            "entry point starts the fake backend at world size 512 "
            "(repro_torch.launch.dryrun)")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


# H100 SXM per-GPU constants for the roofline model.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 (chip_smoke.PEAKS)
HBM_BW = 3.35e12                  # bytes/s, HBM3 (chip_smoke.PEAKS)
# bytes/s per GPU on a 16-wide mesh axis: 8-GPU NVLink nodes make every
# such ring cross nodes, so its slowest hop is the GPU's 400 Gb/s
# InfiniBand NDR link. A ring within one node would run at NVLink 4's
# 450 GB/s per direction; the roofline keeps the reference's single
# collective term.
LINK_BW = 50e9
