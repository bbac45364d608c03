"""Device meshes over the ranks of a process group: the port of the JAX
package's ``launch/mesh.py``.

Each builder is a function, so importing this module touches no device
and no process group. The mesh is torch's ``DeviceMesh`` with the
reference's dimension names: ("data", "model"), or ("pod", "data",
"model") with ``multi_pod``. The flat federated trainer splits its (K, D)
stacks along D over "model" (``fed_trainer.flat_param_sharding``). The
caller joins the process group first
(:func:`repro_torch.distributed.init_distributed`, with its address,
world size and rank: nothing on a machine tells a program of a cluster).
It puts each rank on its card and joins over NCCL where every rank has
one of its own, over gloo where ranks share a GPU (NCCL refuses them) or
run on the CPU.

The constants are the NVIDIA H100 SXM data sheet's per-GPU figures, for
rooflines; they are not measurements.
"""
from __future__ import annotations

import torch.distributed as dist

#: dense BF16 tensor-core FLOP/s (the data sheet's 1,979 TFLOPS is with
#: 2:4 sparsity)
PEAK_FLOPS_BF16 = 1979e12 / 2
#: FP32 FLOP/s (CUDA cores)
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bandwidth, B/s
HBM_BW = 3.35e12
#: NVLink, B/s per link: 900 GB/s over 18 fourth-generation links
NVLINK_BW_PER_LINK = 900e9 / 18


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the process group: join it first "
                           "(repro_torch.distributed.init_distributed)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, multi_pod=False,
                    device_type: str = "cuda"):
    """A small mesh for tests: (n_data, n_model) over ("data", "model"),
    or (2, n_data, n_model) over ("pod", "data", "model"); its size must
    be the process group's. ``device_type="cpu"`` for gloo ranks on the
    CPU."""
    if multi_pod:
        return _mesh((2, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The mesh of the ranks the process group has: every rank on
    "model" (1, W), or with ``multi_pod`` two pods of W/2 (2, 1, W/2).
    The reference's layout, 256 or 512 TPU v5e chips as (16, 16) and (2,
    16, 16), is not this machine's: here W is the group's size, one rank
    per GPU (or per gloo process)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if multi_pod:
        if world % 2:
            raise ValueError(f"multi_pod needs an even number of ranks, got "
                             f"{world}")
        return _mesh((2, 1, world // 2), ("pod", "data", "model"),
                     device_type)
    return _mesh((1, world), ("data", "model"), device_type)
