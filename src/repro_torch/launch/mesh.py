"""Production mesh factory, the ambient mesh, and the card's peaks.

Port of ``repro/launch/mesh.py``. A mesh is a ``torch.distributed``
``DeviceMesh`` with named dimensions, built by FUNCTIONS (never at import)
over the process group the caller started: NCCL on the card, gloo on the
CPU, or the fake group the dry-run traces over (``launch/dryrun.py``).

The peaks the roofline reads are the H100 SXM datasheet's, for the card
the port runs on (``nvidia-smi``: NVIDIA H100 80GB HBM3, 700.00 W):

* ``PEAK_FLOPS_BF16``: 989 TFLOP/s, bf16 dense on the tensor cores;
* ``HBM_BW``: 3.35 TB/s of HBM3;
* ``NVLINK_BW``: 450 GB/s a direction between two cards of one 8-card node;
* ``IB_BW``: 50 GB/s a card between nodes (one 400 Gb/s NDR port a card).

A collective's bytes go at the slowest link its group crosses
(:func:`link_bw`): ranks are laid out row-major over the mesh and
``GPUS_PER_NODE`` consecutive ranks share a node.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.models import sharding

PEAK_FLOPS_BF16 = 989e12  # H100 SXM bf16 dense (NVIDIA H100 80GB HBM3, 700.00 W)
HBM_BW = 3.35e12  # bytes/s, H100 SXM HBM3 (NVIDIA H100 80GB HBM3, 700.00 W)
NVLINK_BW = 450e9  # bytes/s a direction inside an 8-GPU node (NVIDIA H100 80GB HBM3, 700.00 W)
IB_BW = 50e9  # bytes/s a GPU between nodes, InfiniBand NDR (NVIDIA H100 80GB HBM3, 700.00 W)
GPUS_PER_NODE = 8

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group (``init_device_mesh``). The device type is the card's unless the
    caller asks for ``"cpu"``; asking for the card without one raises."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device_type='cpu' for a CPU mesh")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def use_mesh(mesh):
    """The ambient mesh the sharding constraints read
    (``models/sharding.py``), for the body of the ``with``."""
    prev = sharding.current_mesh()
    sharding.set_mesh(mesh)
    try:
        yield mesh
    finally:
        sharding.set_mesh(prev)


def group_ranks(shape, axes, group_axes) -> list:
    """The rank groups along ``group_axes`` of a row-major mesh of
    ``shape`` named ``axes``: lists of global ranks."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    keep = [axes.index(a) for a in group_axes]
    rest = [i for i in range(len(shape)) if i not in keep]
    moved = np.transpose(grid, rest + keep).reshape(-1, int(np.prod([shape[i] for i in keep])))
    return [list(map(int, g)) for g in moved]


def link_bw(shape, axes, group_axes) -> float:
    """The rate of the slowest link a collective along ``group_axes``
    crosses: ``IB_BW`` if a group spans nodes, else ``NVLINK_BW`` (a group
    of one rank moves nothing; ``NVLINK_BW`` then)."""
    for g in group_ranks(tuple(shape), tuple(axes), tuple(group_axes)):
        if len({r // GPUS_PER_NODE for r in g}) > 1:
            return IB_BW
    return NVLINK_BW
