"""Placement rules for the ("pod", "data", "model") mesh, the lane mesh of
scenario grids, and the host-side process helpers of the sweep service:
the port of the JAX package's ``repro/distributed/sharding.py``.

Parameters are placed by leaf-path rules on their *trailing* dimensions,
so one table serves plain trees, layer-stacked trees (leading L) and
agent-stacked trees (leading K). Federation mapping:

* ``fed_axis="data"``: agents on every (pod, data) rank, K = pods·data;
  the per-agent batch whole on each;
* ``fed_axis="pod"``: one agent per pod, K = pods; "data" splits the
  agent's batch (and, with ``fsdp_layers``, its layer-stack dimension);
* ``fed_axis="all"``: one agent per rank, no tensor parallelism.

A placement is a :class:`PartitionSpec`, one entry per tensor dimension:
None, a mesh dimension's name, or a tuple of names (the first name the
major one), as in the reference. :func:`placements` turns a spec into a
``DeviceMesh``'s DTensor placements. The rules read only the mesh's
dimension names and sizes, so they run on an :class:`AbstractMesh` as on
a ``DeviceMesh`` (:mod:`repro_torch.launch.mesh`).

Every rank joins through :func:`init_distributed`: on CUDA it takes a
card of its own where the host has one per rank and joins over NCCL, so
the tensor collectives of the carriers stay on the device; where ranks
share a card (NCCL refuses two ranks on one GPU) or run on the CPU they
join over gloo. Host objects (the sweep's carries, generator states and
history chunks, pickled; the lane mesh's gathered rows) go over gloo
either way (:func:`host_group`).

The lane mesh (:func:`lane_mesh`) lays out the flattened lanes × seeds
rows of ``run_grid(lanes=True)``. The reference's is a 1-D mesh of
devices; the port's is the process group's ranks, one device each
(:class:`LaneMesh`), and on one process it is None, the identity layout.
Each rank runs its block of rows (:func:`lane_sharding`), and after a
lane program every rank holds every row (:func:`lane_out_sharding`,
:func:`gather_rows`).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.carriers import columns, placed
from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_map, tree_paths


def rank_card(process_id: int, cards: int,
              local_rank: Optional[int] = None) -> int:
    """The card of a rank: its ``local_rank`` (``LOCAL_RANK``) when set,
    else its rank, modulo the host's ``cards``."""
    if cards < 1:
        raise RuntimeError("a rank on CUDA needs a card and the host has "
                           "none; join with device='cpu'")
    return (process_id if local_rank is None else local_rank) % cards


def choose_backend(device_type: str, ranks_on_host: int, cards: int,
                   backend: Optional[str] = None) -> str:
    """The process group's backend: ``nccl`` where the ranks run on CUDA
    and each rank on the host has a card of its own (``ranks_on_host <=
    cards``), ``gloo`` on the CPU and where ranks share a card (NCCL
    refuses two ranks on one GPU). A named ``backend`` is taken as is,
    but NCCL where it cannot run raises here, before NCCL's own "Duplicate
    GPU" error."""
    own = device_type == "cuda" and ranks_on_host <= cards
    if backend is None:
        return "nccl" if own else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port joins over "
                         f"'nccl' or 'gloo'")
    if backend == "nccl" and not own:
        raise ValueError(
            f"NCCL needs a card per rank: {ranks_on_host} ranks on this "
            f"host, {cards} cards, device type {device_type!r}; join over "
            f"gloo (backend=None picks it)")
    return backend


#: the gloo group made beside an NCCL world for host objects, and the
#: world it belongs to (:func:`host_group`)
_HOST_GROUP: list = []


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int,
                     timeout_s: Optional[float] = None, device="cuda",
                     backend: Optional[str] = None,
                     group_of_one: bool = False) -> torch.device:
    """Join a process group of ``num_processes`` ranks through the TCP
    store at ``coordinator`` (``HOST:PORT``, served by rank 0), the one
    place where the port joins one. Returns the rank's device.

    On CUDA the rank takes its card (:func:`rank_card`: ``LOCAL_RANK``
    when set, else the rank modulo the host's cards) and makes it current
    before it joins; the backend follows :func:`choose_backend` (NCCL
    where every rank on the host owns its card, initialised eagerly on
    it; gloo where they share one or run on the CPU), the host's ranks
    being ``LOCAL_WORLD_SIZE`` when set, else the whole group (the
    port's launchers start their ranks on one host). Under NCCL a gloo
    group beside it carries host objects (:func:`host_group`). A failed
    NCCL join raises; nothing falls back to gloo. With ``timeout_s``,
    joining and every collective raise after that many seconds without
    their peers (torch's default: 30 minutes; a backward whose
    collectives run in another order on two ranks waits that long).

    A single process joins nothing and picks no card (``device`` comes
    back as given) unless ``group_of_one``: a one-rank mesh needs its
    group."""
    dev = torch.device(device)
    if num_processes <= 1 and not group_of_one:
        return dev
    cards = 0
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", rank_card(
            process_id, cards, None if local is None else int(local)))
        torch.cuda.set_device(dev)
    backend = choose_backend(
        dev.type, int(os.environ.get("LOCAL_WORLD_SIZE", num_processes)),
        cards, backend)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            device_id=dev if backend == "nccl" else None,
                            **kw)
    _HOST_GROUP.clear()
    if backend == "nccl":
        _HOST_GROUP.extend([dist.group.WORLD,
                            dist.new_group(backend="gloo", **kw)])
    return dev


def leave_distributed() -> None:
    """Leave the process group that :func:`init_distributed` joined: the
    one teardown of the port. It drops the host group first, then
    destroys every group. A host group still held here would outlive
    ``destroy_process_group``: the gloo group and its store are then torn
    down with the interpreter at exit, which aborts the rank ("terminate
    called without an active exception"; 8 of 48 two-rank runs, six at a
    time, on an 8-core host)."""
    _HOST_GROUP.clear()
    dist.destroy_process_group()


def host_group():
    """The group over which ranks exchange host objects (pickled carries,
    generator states, rows): the gloo group made beside an NCCL world by
    :func:`init_distributed`, else None, the world itself (gloo: host
    objects need no device)."""
    if _HOST_GROUP and dist.is_initialized() \
            and _HOST_GROUP[0] is dist.group.WORLD:
        return _HOST_GROUP[1]
    return None


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s host object ``obj`` (pickled) on every rank, over
    :func:`host_group`: how the sweep's ranks agree on a reading."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=host_group())
    return box[0]


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


# ---------------------------------------------------------------------------
# Lane mesh: the rows of the engine's scenario groups over the processes
# ---------------------------------------------------------------------------


class LaneMesh(NamedTuple):
    """The ranks of the process group as a 1-D ("lane",) mesh: its size
    and this process's rank."""
    size: int
    rank: int


#: lane-mesh override stack (:func:`use_lane_mesh`); the top entry, which
#: may be None (no layout), replaces the default everywhere the engine
#: asks for a lane mesh
_LANE_MESH: list = []


@contextlib.contextmanager
def use_lane_mesh(mesh: Optional[LaneMesh]):
    """Install ``mesh`` as the engine's lane mesh for the extent of the
    context: how the sweep's ``span`` mode points the lane machinery at
    the process-spanning mesh without passing a mesh through every layer.
    None turns the layout off."""
    _LANE_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _LANE_MESH.pop()


def lane_mesh(spanning: bool = False) -> Optional[LaneMesh]:
    """The lane mesh: the one :func:`use_lane_mesh` installed, else None
    (one device per process: the identity layout), or with ``spanning``
    the process group's ranks (None on one process)."""
    if _LANE_MESH:
        return _LANE_MESH[-1]
    if not spanning or process_count() <= 1:
        return None
    return LaneMesh(process_count(), process_index())


def lane_sharding(mesh: Optional[LaneMesh], n_rows: int) -> Optional[range]:
    """This rank's block of ``n_rows`` rows on the lane mesh; None (every
    rank runs every row) without a mesh or when the rows do not divide
    over it (the engine pads them to :func:`padded_rows` so they do)."""
    if mesh is None or n_rows % mesh.size:
        return None
    return row_block(n_rows, mesh.size, mesh.rank)


def spans_processes(mesh: Optional[LaneMesh]) -> bool:
    """True when the mesh holds more than one process."""
    return mesh is not None and mesh.size > 1


def lane_out_sharding(mesh: Optional[LaneMesh],
                      n_rows: int) -> Optional[range]:
    """The rows a rank holds after a lane program: every row on a
    process-spanning mesh (gathered, so any rank can summarize and
    checkpoint), its own block otherwise, None without a layout."""
    block = lane_sharding(mesh, n_rows)
    if block is not None and spans_processes(mesh):
        return range(n_rows)
    return block


def padded_rows(mesh: Optional[LaneMesh], n_rows: int) -> int:
    """The smallest multiple of the mesh's size >= ``n_rows`` (``n_rows``
    without a mesh): the engine pads a group's rows to it with copies of
    the last row, sliced off before the summaries."""
    if mesh is None or n_rows % mesh.size == 0:
        return n_rows
    return -(-n_rows // mesh.size) * mesh.size


def global_rows(mesh: Optional[LaneMesh], arr):
    """This rank's rows of an ``(R, ...)`` array every process holds
    whole (the sweep's operands derive from the grid alike on every
    rank): the reference assembles a global array from such copies; here
    each rank keeps its block (all of it without a layout)."""
    block = lane_sharding(mesh, len(arr))
    return arr if block is None else arr[block.start:block.stop]


def gather_rows(mesh: LaneMesh, tree):
    """Every rank's block of rows, concatenated in rank order on every
    rank: ``tree``'s leaves (numpy arrays, or tensors, moved to the host)
    hold this rank's rows on their leading axis. The rows go as host
    objects over :func:`host_group`."""
    # analysis: host-side (gloo exchanges the rows as host objects)
    part = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor)
                    else x, tree)
    parts = [None] * mesh.size
    dist.all_gather_object(parts, part, group=host_group())
    return tree_map(lambda *xs: torch.cat(xs)
                    if isinstance(xs[0], torch.Tensor)
                    else np.concatenate(xs), *parts)


def row_block(n_rows: int, n_proc: int, pid: int) -> range:
    """Rank ``pid``'s contiguous block of ``n_rows`` rows: the first
    ``n_rows % n_proc`` ranks take one row more."""
    base, rem = divmod(n_rows, n_proc)
    start = pid * base + min(pid, rem)
    return range(start, start + base + (1 if pid < rem else 0))


class AbstractMesh(NamedTuple):
    """A mesh's dimension sizes and names without ranks (the reference's
    ``jax.sharding.AbstractMesh``): what the placement rules read."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, mesh_dim: int) -> int:
        return self.shape[mesh_dim]


def mesh_axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension ``name``; 1 when the mesh (or None)
    has no such dimension."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh.size(names.index(name)) if name in names else 1


def _has(mesh, name: str) -> bool:
    return name in (getattr(mesh, "mesh_dim_names", None) or ())


# ---------------------------------------------------------------------------
# Specs and placements
# ---------------------------------------------------------------------------

def _entry(e):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a
    one-name tuple is the name, an empty tuple None."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec:
    """The placement of a tensor on a mesh (the reference's
    ``PartitionSpec``): one entry per dimension, None (whole on every
    rank), a mesh dimension's name or a tuple of names (split over their
    product, the first name major). ``PartitionSpec()`` is replicated,
    whatever the rank of the tensor. It iterates and compares as the
    tuple of its entries, and is a leaf of the port's trees."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


def _axes(entry) -> tuple:
    """A spec entry's mesh dimension names, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """A :class:`PartitionSpec` -> the DTensor placements on ``mesh`` (a
    ``DeviceMesh``): ``Shard(d)`` on every mesh dimension that splits
    tensor dimension d, ``Replicate()`` on the others. DTensor applies
    the shards of one tensor dimension in mesh-dimension order, the first
    major, so a tuple of names must list them in the mesh's order: then
    each rank holds the block that the reference's ``PartitionSpec`` gives
    it (``P(("pod", "data"))`` is pod-major)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec}: the mesh {names} has no "
                                 f"dimension {ax!r}")
            i = names.index(ax)
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec}: mesh dimension {ax!r} "
                                 f"splits two tensor dimensions")
            out[i] = Shard(d)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the names of a tuple must follow "
                             f"the mesh's order {names}")
    return tuple(out)


# ---------------------------------------------------------------------------
# Leaf placement rules
# ---------------------------------------------------------------------------

#: leaf name -> the trailing dimension that "model" splits
_MODEL_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv",
               "w_uq", "w_uk", "w_uv", "lm_head"}
_MODEL_SECOND = {"wo", "w_down"}
_REPLICATE = {"router", "norm_attn", "norm_mlp", "final_norm", "norm_m",
              "norm_s", "frontend_proj", "w_dq", "w_dkv"}


def fed_axes(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """The mesh dimensions that split the K agents."""
    has_pod = _has(mesh, "pod")
    if cfg.fed_axis == "pod":
        return ("pod",) if has_pod else ()
    if cfg.fed_axis == "all":
        # one agent per rank: no tensor parallelism, the only collectives
        # left are the aggregation and the agreement
        return ("pod", "data", "model") if has_pod else ("data", "model")
    return ("pod", "data") if has_pod else ("data",)


def n_agents(cfg: ModelConfig, mesh) -> int:
    """K: the product of the federation dimensions' sizes (at least 1)."""
    n = 1
    for a in fed_axes(cfg, mesh):
        n *= mesh_axis_size(mesh, a)
    return max(n, 1)


def batch_axes(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """The mesh dimensions that split the per-agent batch."""
    if cfg.fed_axis == "pod":
        return ("data",)
    if getattr(cfg, "intra_agent_dp", False) and cfg.fed_axis == "data":
        return ("model",)
    return ()


def _path_names(path) -> list:
    """A leaf's dict keys along its path: a ``tree_paths`` path ("a/b/c";
    list indices, all digits, dropped) or a sequence of keys (ints
    dropped), as the reference keeps its ``DictKey`` and ``GetAttrKey``
    entries."""
    parts = path.split("/") if isinstance(path, str) else list(path)
    return [str(p) for p in parts
            if not isinstance(p, int) and not (isinstance(p, str)
                                               and (p.isdigit() or not p))]


def param_spec(cfg: ModelConfig, path, leaf, mesh,
               stacked: bool = False) -> PartitionSpec:
    """The :class:`PartitionSpec` of one parameter leaf (a tensor) at
    ``path``; ``stacked``: the leaf carries the K agents first."""
    names = _path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    spec = [None] * ndim
    if cfg.fed_axis == "all" or getattr(cfg, "intra_agent_dp", False):
        # an agent's parameters whole on its ranks (no tensor parallelism)
        if stacked:
            axes = fed_axes(cfg, mesh)
            spec[0] = axes if axes else None
        return PartitionSpec(*spec)
    msize = mesh_axis_size(mesh, "model")
    model_ok = msize > 1
    in_recurrent = (cfg.family == "ssm") or ("ssm" in names) \
        or ("m" in names) or ("s" in names)
    e = cfg.moe.n_experts if cfg.moe is not None else 0
    expert_leaf = (cfg.moe is not None and "mlp" in names
                   and name in ("w_gate", "w_up", "w_down")
                   and "shared" not in names)

    def put(dim, axis="model"):
        if shape[dim] % msize == 0:
            spec[dim] = axis

    if model_ok and not in_recurrent and name not in _REPLICATE:
        if name == "embed":
            put(-2)                     # vocab-parallel
        elif expert_leaf and e % msize == 0:
            put(-3)                     # expert-parallel
        elif name in _MODEL_LAST:
            put(-1)
        elif name in _MODEL_SECOND:
            put(-2)
    # FSDP over layers: "data" splits the layer-stack dimension
    dsize = mesh_axis_size(mesh, "data")
    if (getattr(cfg, "fsdp_layers", False) and names
            and names[0] == "blocks" and dsize > 1):
        ldim = 1 if stacked else 0
        if ldim < ndim and spec[ldim] is None \
                and shape[ldim] % dsize == 0:
            spec[ldim] = "data"
    if stacked:                 # the leaf carries the leading K dimension
        axes = fed_axes(cfg, mesh)
        spec[0] = axes if axes else None
    return PartitionSpec(*spec)


def param_shardings(cfg: ModelConfig, params_shape, mesh,
                    stacked: bool = False):
    """The tree of specs (:class:`PartitionSpec`) of a parameter tree,
    its leaves tensors on any device (``meta`` included)."""
    specs = iter([param_spec(cfg, path, leaf, mesh, stacked)
                  for path, leaf in tree_paths(params_shape)])
    return tree_map(lambda _: next(specs), params_shape)


#: how the serving route uses a parameter leaf (:func:`serve_use`)
SERVE_USES = ("whole", "cols", "rows", "vocab", "experts", "gather")


def serve_use(cfg: ModelConfig, path, spec, mesh) -> str:
    """How :func:`repro_torch.distributed.serving.make_serve_fns` uses a
    parameter leaf at ``path`` placed by ``spec`` (its
    :func:`param_spec`, ``stacked=False``) on ``mesh``, one layer at a
    time. The serving route, the dry run's reckoning and the tests read
    this one rule:

    * ``"whole"``: "model" does not split it; used as the rank holds it;
    * ``"cols"``: column-parallel on its last dimension (whole heads of
      ``wq`` and the biases, and of ``wk``/``wv`` where the KV heads
      divide too; MLA's ``wq`` or ``w_uq``, ``w_uk`` and ``w_uv``, head
      by head; ``d_ff`` columns of ``w_gate``/``w_up``; the vocabulary
      columns of ``lm_head``);
    * ``"rows"``: row-parallel on dimension -2 (``wo`` on whole heads,
      ``w_down``): partial products, summed in rank order;
    * ``"vocab"``: the embedding's rows, a vocabulary block;
    * ``"experts"``: an expert block (dimension -3);
    * ``"gather"``: gathered whole for its layer, the split cutting what
      a rank cannot use alone: a head (query heads that do not divide,
      MLA's among them, or ``wk``/``wv`` whose KV heads do not)."""
    names = _path_names(path)
    name = names[-1] if names else ""
    m = mesh_axis_size(mesh, "model")
    split = [d - len(spec) for d, e in enumerate(spec) if "model" in _axes(e)]
    if m == 1 or not split:
        return "whole"
    if name == "embed":
        return "vocab"
    if split[0] == -3:
        return "experts"
    if "attn" in names and (cfg.n_heads % m or (
            name in ("wk", "wv", "bk", "bv") and cfg.n_kv_heads % m)):
        return "gather"
    return "cols" if split[0] == -1 else "rows"


def serve_uses(cfg: ModelConfig, params_shape, specs, mesh):
    """:func:`serve_use` of every leaf of a parameter tree (its specs
    ``specs``), as a tree of the same structure."""
    uses = iter([serve_use(cfg, path, spec, mesh)
                 for path, spec in tree_paths(specs)])
    return tree_map(lambda _: next(uses), params_shape)


def batch_spec(cfg: ModelConfig, mesh, stacked: bool = True) -> PartitionSpec:
    """The spec of token batches: (K, b, S) when ``stacked``, else the
    serving batch (B, S) over every non-"model" dimension."""
    fa = fed_axes(cfg, mesh)
    ba = batch_axes(cfg, mesh)
    if stacked:
        return PartitionSpec(fa if fa else None, ba if ba else None)
    axes = tuple(a for a in ("pod", "data") if _has(mesh, a))
    return PartitionSpec(axes if axes else None)


def cache_shardings(cfg: ModelConfig, cache_shape, mesh):
    """The specs of a decode cache (:func:`repro_torch.models.model.
    init_cache`'s tree, the reference's names and ranks): the batch
    dimension (1 of every stacked (L, B, ...) leaf) over (pod, data);
    K and V (L, B, W, Hkv, hd) over "model" on their heads (or, where
    the heads do not divide, on the ring W); MLA's latent ``c`` and
    ``k_rope`` (L, B, W, r) on W; ``pos`` and ``slot_pos`` replicated."""
    axes = tuple(a for a in ("pod", "data") if _has(mesh, a))
    msize = mesh_axis_size(mesh, "model")
    model_ok = msize > 1
    bsize = 1
    for a in axes:
        bsize *= mesh_axis_size(mesh, a)

    def spec(path, leaf):
        names = _path_names(path)
        name = names[-1] if names else ""
        if name in ("pos", "slot_pos"):
            return PartitionSpec()
        shape = tuple(leaf.shape)
        nd = len(shape)
        s = [None] * nd
        if nd >= 2 and shape[1] % max(bsize, 1) == 0:
            s[1] = axes if axes else None
        if model_ok:
            if name in ("k", "v") and nd == 5:
                if cfg.n_kv_heads % msize == 0:
                    s[3] = "model"
                elif shape[2] % msize == 0:
                    s[2] = "model"              # the ring split instead
            elif name in ("c", "k_rope") and nd == 4:
                if shape[2] % msize == 0:
                    s[2] = "model"
        return PartitionSpec(*s)

    specs = iter([spec(path, leaf) for path, leaf in tree_paths(cache_shape)])
    return tree_map(lambda _: next(specs), cache_shape)


# ---------------------------------------------------------------------------
# Layout hints
# ---------------------------------------------------------------------------

#: the meshes installed by :func:`use_mesh`, innermost last
_CTX_MESH: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` for :func:`ctx_mesh` and :func:`maybe_shard` over
    the context (the reference's ``jax.set_mesh``)."""
    _CTX_MESH.append(mesh)
    try:
        yield mesh
    finally:
        _CTX_MESH.pop()


def ctx_mesh():
    """The mesh installed by :func:`use_mesh`; None outside one."""
    return _CTX_MESH[-1] if _CTX_MESH else None


def place_tree(tree, specs, mesh):
    """A tree every rank holds whole -> the same tree on ``mesh``, each
    leaf on its spec's placements (``specs`` a tree of
    :class:`PartitionSpec` of the same structure): a DTensor of the
    rank's block (``placed.place``: no collective; on a one-rank mesh the
    block is the leaf itself, no copy), or the plain leaf, the same on
    every rank, where the spec is ``PartitionSpec()``."""
    def put(t, spec):
        return placed.place(t, mesh, placements(spec, mesh)) \
            if len(spec) else t
    return tree_map(put, tree, specs)


def shard_hint(x, mesh, spec):
    """``x`` on ``spec``'s placements over ``mesh``; ``x`` itself without
    a mesh. A tensor every rank holds whole keeps its block (no
    collective, :func:`repro_torch.carriers.placed.place`); a DTensor
    on other placements is redistributed (DTensor's own collectives)."""
    if mesh is None:
        return x
    places = placements(spec, mesh)
    if not columns.is_dtensor(x):
        return placed.place(x, mesh, places)
    if tuple(x.placements) == places:
        return x
    return x.redistribute(mesh, places)


def maybe_shard(x, *spec):
    """:func:`shard_hint` on the mesh of :func:`ctx_mesh`: a no-op
    outside :func:`use_mesh`, so model code can pin a layout without
    breaking the one-process route."""
    mesh = ctx_mesh()
    return x if mesh is None else shard_hint(x, mesh, PartitionSpec(*spec))
