"""Host-side process helpers of the sweep service and the mesh's axis
sizes: the port of the host part of the JAX package's
``repro/distributed/sharding.py`` and its ``mesh_axis_size``.

The processes exchange only host objects (carries, generator states and
history chunks, pickled), so the process group is gloo on the CPU and on
CUDA alike: NCCL would also refuse two ranks on one GPU. A mesh is
torch's ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`); the flat
trainer's D split needs only :func:`mesh_axis_size`. The leaf placement
rules of the tree trainer under a mesh (``fed_axes``, ``param_spec``,
``param_shardings``, ``batch_spec``, ``cache_shardings``, ...) and the
lane functions wait.
"""
from __future__ import annotations

import torch.distributed as dist


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join a gloo process group of ``num_processes`` ranks through the
    TCP store at ``coordinator`` (``HOST:PORT``, served by rank 0). No-op
    for a single process."""
    if num_processes <= 1:
        return
    dist.init_process_group(backend="gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_assignment(costs, n_hosts: int) -> list:
    """Greedy longest-processing-time schedule: ``assign[i]`` is the
    host owning group ``i``, balancing summed cost per host: the sweep's
    ``shard`` mode. Uneven groups land on the least-loaded host (ties to
    the lowest rank), so no process idles while another drains a long
    tail."""
    costs = [float(c) for c in costs]
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], i))
    loads = [0.0] * max(int(n_hosts), 1)
    assign = [0] * len(costs)
    for i in order:
        h = min(range(len(loads)), key=lambda j: (loads[j], j))
        assign[i] = h
        loads[h] += costs[i]
    return assign


def row_block(n_rows: int, n_proc: int, pid: int) -> range:
    """Rank ``pid``'s contiguous block of ``n_rows`` rows: the first
    ``n_rows % n_proc`` ranks take one row more."""
    base, rem = divmod(n_rows, n_proc)
    start = pid * base + min(pid, rem)
    return range(start, start + base + (1 if pid < rem else 0))


def mesh_axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension ``name``; 1 when the mesh (or None)
    has no such dimension."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh.size(names.index(name)) if name in names else 1
