"""Per-card hardware constants and the production meshes
(``repro.launch.mesh``, whose constants are the TPU v5e's).

NVIDIA H100 SXM, from NVIDIA's H100 data sheet (dense rates, no
sparsity, at the 700 W power limit); ``repro_torch.roofline`` prices
with them, and ``chip_smoke.py`` bounds its kernels with them.

Meshes. The reference's meshes are single pod, 256 chips as (16, 16) =
("data", "model"), and two pods, (2, 16, 16) = ("pod", "data",
"model"). Here they are ``torch.distributed`` ``DeviceMesh``es built over
the default process group, which the caller initialises first: a real
one (``nccl``, ``gloo``) or, for the dry run, a fake one of 256 or 512
ranks on one host. ``MeshShape`` is the mesh as the sharding rules see it
(axis names and sizes), so the rules and their tests run without any
process group.

Links. The ranks of a mesh are laid out in mesh order (the last axis
fastest), eight GPUs to a node joined by NVLink (``GPUS_PER_NODE``). A
collective over a mesh axis whose ranks all sit in one node moves at
``NVLINK_BW`` (450 GB/s a direction, NVLink 4, H100 SXM data sheet); one
whose ranks span nodes at ``IB_BW`` a GPU (one ConnectX-7 NIC of 400
Gb/s, 50 GB/s, per GPU, NVIDIA DGX H100 user guide). On the production
meshes every axis spans nodes: the "model" axis holds 16 consecutive
ranks, two nodes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_FLOPS_TF32 = 495e12          # FLOP/s, TF32 tensor cores
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
NVLINK_BW = 450e9                 # bytes/s per direction
IB_BW = 50e9                      # bytes/s per GPU, one 400 Gb/s NIC
GPUS_PER_NODE = 8

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, in mesh order: ``axis_names`` and
    ``shape`` (a name -> size dict) as the reference's ``Mesh`` offers
    them to its rules."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """A ``DeviceMesh`` (or anything with ``mesh_dim_names`` and a
        ``shape`` tuple) as a ``MeshShape``."""
        if isinstance(mesh, MeshShape):
            return mesh
        return cls(tuple(mesh.mesh_dim_names), tuple(int(s) for s in
                                                     mesh.shape))

    @classmethod
    def production(cls, *, multi_pod: bool = False) -> "MeshShape":
        sizes, names = PRODUCTION[multi_pod]
        return cls(names, sizes)


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in MeshShape.of(mesh).sizes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over the default process group (256 or 512 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    sizes, names = PRODUCTION[multi_pod]
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def make_host_mesh(device_type="cpu"):
    """A (1, 1) mesh with the production axis names, over a default
    process group of one rank."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def axis_link_bw(mesh, axis: str) -> float:
    """Bytes a second a GPU of ``mesh`` moves in a collective over
    ``axis``: NVLink when the axis's ranks all sit in one node, else the
    inter-node NIC."""
    m = MeshShape.of(mesh)
    i = m.axis_names.index(axis)
    stride = 1
    for s in m.sizes[i + 1:]:
        stride *= s
    span = stride * m.sizes[i]       # the ranks one line of the axis covers
    inside = span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0
    return NVLINK_BW if inside else IB_BW
