"""Roofline terms and collective bytes of the port's programs, from shapes
and specs: the port of the JAX package's ``launch/analysis.py``.

  compute term    = per_device_FLOPs / peak_FLOP/s        [s]
  memory term     = per_device_bytes / HBM_bw             [s]
  collective term = per_device_wire_bytes / NVLink_bw     [s]

The reference reads FLOPs and bytes from a compiled module's
``cost_analysis()`` and the wire bytes from its optimized HLO. A torch
program has neither, so here the caller gives the FLOPs and bytes
(:mod:`repro_torch.launch.dryrun`: the analytic MODEL_FLOPS split over
the devices, and the bytes each device's arguments and outputs hold), and
the wire bytes are reckoned from the collectives the port's route issues.

Every collective of the port's mesh routes is an ``all_gather`` through
:func:`repro_torch.carriers.columns.gather_over`, the rank sums of
:func:`repro_torch.carriers.placed.rank_sum` included (each rank's
partial gathered, then added in rank order). Each is counted with the
reference's ring formula, (g−1)/g × out, g the ranks of its group and out
the bytes it gathers. :func:`serve_gathers` (each labelled with what it
gathers) and :func:`fed_step_gathers` list them in the order the route
issues them:

* a serving call's rank-order sums of partial activations (the
  vocabulary-parallel embedding, each layer's head-parallel attention
  and its d_ff- or expert-parallel MLP), its logits gathered along the
  vocabulary, and per layer the leaves it cannot use on their blocks
  gathered whole, a layer split over "data" gathered from its rank, and
  a decode's ring split on W gathered for the layer
  (:func:`serve_gathers`);
* one agent's loss and gradient on a rank's rows and blocks
  (:func:`train_gathers`): the forward's rank-order sums and layer
  gathers, remat's recompute of each layer, the backward's conjugate
  sums and layer gradients brought to their holders, the vocabulary-
  parallel loss's block sums, and the gradients' sums over the batch
  dimensions;
* a federated step's losses and Adam's counters gathered
  over the federation dimensions, the leaves' K rows gathered for the
  aggregation, the attacks' honest sums and GDA's mix, and the (K, K)
  Gram partials (and the telemetry's squared norms) summed over the
  dimensions that split the leaves.

Not counted: activations and the allocator's workspaces (no collective
moves them), and the host staging of a gloo group on CUDA tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import tree_paths
from repro_torch.distributed.sharding import (PartitionSpec,
                                              mesh_axis_size, serve_use)
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW_PER_LINK, PEAK_FLOPS_BF16

#: one collective: the bytes it gathers (its output, all parts) and its
#: group's size
Gather = Tuple[int, int]

_TYPES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def route_wire_bytes(gathers: Sequence[Gather]) -> Dict[str, float]:
    """Per-device wire bytes by collective type, the reference's dict
    (``collective_wire_bytes``): every type's bytes, ``"total"`` and
    ``"counts"``; the port's collectives are all ``all_gather``s, each
    (g−1)/g × out on the wire. ``"gathers"`` keeps the list."""
    out: Dict[str, float] = dict.fromkeys(_TYPES, 0.0)
    counts = dict.fromkeys(_TYPES, 0)
    for nbytes, g in gathers:
        if g <= 1:
            continue
        out["all-gather"] += nbytes * (g - 1) / g
        counts["all-gather"] += 1
    out["total"] = sum(out.values())
    out["counts"] = counts
    out["gathers"] = [tuple(x) for x in gathers if x[1] > 1]
    return out


def roofline_terms(cost: dict, wire: Dict[str, float], n_chips: int,
                   model_flops_global: float = 0.0,
                   loop_scale: int = 1) -> dict:
    """The three roofline terms (seconds) + the dominant bottleneck, with
    the H100 data sheet's constants (:mod:`repro_torch.launch.mesh`).

    ``cost``: per-device ``"flops"`` and ``"bytes accessed"``, as the
    reference's ``cost_analysis()`` gives them; its FLOPs count a layer
    loop's body once, so they are scaled by ``loop_scale``. The compute
    term used for the bottleneck is the analytic MODEL_FLOPS one when
    ``model_flops_global`` is given (standard MFU practice), the scaled
    ``cost`` FLOPs kept as ``compute_hlo_s``."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_compute_hlo = flops * loop_scale / PEAK_FLOPS_BF16
    t_compute = (model_flops_global / n_chips) / PEAK_FLOPS_BF16 \
        if model_flops_global else t_compute_hlo
    t_memory = bytes_acc / HBM_BW
    t_coll = float(wire.get("total", 0.0)) / NVLINK_BW_PER_LINK
    terms = {"compute_s": t_compute, "compute_hlo_s": t_compute_hlo,
             "memory_s": t_memory, "collective_s": t_coll}
    terms["bottleneck"] = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    terms["flops_per_device"] = flops
    terms["bytes_per_device"] = bytes_acc
    terms["wire_bytes_per_device"] = float(wire.get("total", 0.0))
    return terms


def model_flops(cfg, shape, n_tokens=None) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode counts the
    single generated token per sequence."""
    if n_tokens is None:
        if shape.mode == "decode":
            n_tokens = shape.global_batch           # one token per sequence
        else:
            n_tokens = shape.global_batch * shape.seq_len
    n = cfg.n_active_params()
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n * n_tokens


# ---------------------------------------------------------------------------
# The route's collectives, from shapes and specs
# ---------------------------------------------------------------------------

class Leaf:
    """A placed leaf as shapes: its global ``shape``, bytes per entry, the
    mesh's dimension sizes and, per dimension, the mesh dimensions that
    split it (major first)."""

    def __init__(self, shape, itemsize: int, sizes, splits):
        self.shape, self.itemsize = tuple(shape), itemsize
        self.sizes, self.splits = tuple(sizes), list(splits)

    @classmethod
    def of(cls, t: torch.Tensor, spec, mesh) -> "Leaf":
        """A tensor (any device, ``meta`` included) on ``spec`` over
        ``mesh``."""
        names = tuple(mesh.mesh_dim_names)
        splits = [()] * t.dim()
        for d, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else \
                (() if entry is None else (entry,))
            splits[d] = tuple(names.index(a) for a in axes)
        return cls(t.shape, t.element_size(),
                   [mesh.size(i) for i in range(len(names))], splits)

    def parts(self, d: int) -> int:
        return math.prod(self.sizes[m] for m in self.splits[d])

    @property
    def block(self) -> List[int]:
        """One rank's block shape (every split divides)."""
        return [-(-n // self.parts(d)) for d, n in enumerate(self.shape)]

    @property
    def block_bytes(self) -> int:
        return math.prod(self.block) * self.itemsize

    @property
    def trailing(self) -> Tuple[int, ...]:
        return tuple(sorted({m for ms in self.splits[1:] for m in ms}))

    def gather(self, dims, block: Optional[List[int]] = None) -> list:
        """The ``all_gather``s of ``placed.gather`` on ``dims`` of
        ``block`` (default: the rank's block): per dimension, each mesh
        dimension of more than one rank that splits it, inner first."""
        cur = list(self.block if block is None else block)
        out = []
        for d in dims:
            for m in reversed(self.splits[d]):
                g = self.sizes[m]
                if g > 1:
                    cur[d] *= g
                    out.append((math.prod(cur) * self.itemsize, g))
        return out


def _tree(pairs):
    """A nested dict from ``(path, leaf)`` pairs."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _leaves(tree, specs, mesh) -> List[Leaf]:
    return [Leaf.of(t, s, mesh) for (_, t), (_, s)
            in zip(tree_paths(tree), tree_paths(specs))]


def serve_gathers(cfg, params_shape, param_specs, mesh, rows: int,
               text: int, prefix: int = 0, cache_shape=None,
               cache_specs=None) -> List[Tuple[Tuple[str, str], int, int]]:
    """The collectives of one prefill (``cache_shape`` None: ``text``
    tokens and ``prefix`` embeddings a row) or decode (one token a row)
    of :func:`repro_torch.distributed.serving.make_serve_fns` on
    ``mesh`` (any mesh with ``mesh_dim_names`` and ``size``), on a rank
    of ``rows`` batch rows, in the order the route issues them, each as
    ((kind, leaf path), bytes gathered, group size), by
    :func:`~repro_torch.distributed.sharding.serve_use`'s rule:

    * ``("sum", "embed")``: the vocabulary-parallel lookups' rank-order
      sum, (rows, text, d);
    * per layer: ``("layer", path)``, the layer's slice of a leaf whose
      layers "data" splits, gathered from every rank of the group;
      ``("whole", path)``, a leaf used whole, gathered over "model"; for
      a decode, ``("cache", path)``, a cache leaf gathered for the layer
      past its rows where the layer does not compute on its block (a
      ring split on W; K and V split on heads the layer runs whole);
      ``("sum", "attn")`` and ``("sum", "mlp")``, the rank-order sums of
      the partial outputs (rows, positions, d);
    * ``("logits", "")``: the logits' vocabulary columns (rows, 1, V).

    A route that no mesh dimension of more than one rank splits issues
    none."""
    P = dict(zip([p for p, _ in tree_paths(params_shape)],
                 _leaves(params_shape, param_specs, mesh)))
    m = mesh_axis_size(mesh, "model")
    if m == 1 and not any(leaf.trailing or leaf.parts(0) > 1
                          for leaf in P.values()):
        return []
    uses = {p: serve_use(cfg, p, s, mesh)
            for p, s in tree_paths(param_specs)}

    def use(path):
        return uses.get(path, "whole")
    isz = P["embed"].itemsize
    decode = cache_shape is not None
    act = rows * (1 if decode else text + prefix) * cfg.d_model * isz
    out = []
    if use("embed") == "vocab":
        out.append((("sum", "embed"),
                    m * rows * (1 if decode else text) * cfg.d_model * isz,
                    m))
    cache = []
    if decode:
        kv_block = use("blocks/attn/wk") == "cols"
        for (path, _), leaf in zip(tree_paths(cache_shape["blocks"]),
                                   _leaves(cache_shape["blocks"],
                                           cache_specs["blocks"], mesh)):
            dims = [d for d in (2, 3) if d < len(leaf.shape)
                    and leaf.parts(d) > 1 and not (d == 3 and kv_block)]
            cache.append((path, leaf, dims))
    blocks = [(p, leaf) for p, leaf in P.items() if p.startswith("blocks/")]
    for _ in range(blocks[0][1].shape[0]):
        for path, leaf in blocks:
            one = [1] + leaf.block[1:]
            slice_bytes = math.prod(one) * leaf.itemsize
            out += [(("layer", path), leaf.sizes[m] * slice_bytes,
                     leaf.sizes[m]) for m in reversed(leaf.splits[0])
                    if leaf.sizes[m] > 1]
            if uses[path] == "gather":
                out += [(("whole", path), b, g) for b, g in
                        leaf.gather(range(1, len(leaf.shape)), one)]
        for path, leaf, dims in cache:
            out += [(("cache", path), b, g) for b, g in
                    leaf.gather(dims, [1] + leaf.block[1:])]
        if use("blocks/attn/wo") == "rows":
            out.append((("sum", "attn"), m * act, m))
        if use("blocks/mlp/w_down") in ("rows", "experts") \
                or use("blocks/mlp/shared/w_down") == "rows":
            out.append((("sum", "mlp"), m * act, m))
    if (use("embed") if cfg.tie_embeddings else use("lm_head")) \
            in ("vocab", "cols"):
        out.append((("logits", ""), rows * cfg.vocab_size * isz, m))
    return out


def train_gathers(cfg, params_shape, param_specs, mesh, rows: int,
                  text: int, prefix: int = 0, row_dims=()
                  ) -> List[Tuple[Tuple[str, str], int, int]]:
    """The collectives of one agent's loss and gradient on a rank's rows
    and blocks (the tree trainer's step on a placed state:
    :func:`repro_torch.distributed.fed_trainer._estimate_blocks`), in
    the order the route issues them, each ((kind, what), bytes gathered,
    group size): ``params_shape`` one agent's leaves and
    ``param_specs`` their specs (``stacked=False``), ``rows`` the rank's
    batch rows of ``text`` tokens (the loss's positions) and ``prefix``
    embeddings, ``row_dims`` the mesh dimensions that split the rows.

    * the forward: ``("sum", "embed")``; per layer the entries of
      :func:`serve_gathers` (its ``"layer"`` slices over "data", its
      ``"whole"`` leaves, the attention's and the MLP's rank-order sums);
      the loss's ``("max", "logits")``, ``("sum", "lse")`` and
      ``("sum", "label")`` over the vocabulary blocks (f32, a row and
      position each);
    * the backward: ``("enter", "head")``, the head's input's partial
      gradients summed; per layer, last first, the layer's forward
      again (remat's recompute), then its conjugate sums in the order
      autograd reaches them (``("enter", "shared")``, ``("enter",
      "router")`` the routing weights, ``("enter", "mlp")``; ``("enter",
      "v")``, ``("enter", "k")`` where K and V are computed for every KV
      head, ``("enter", "attn")``; for MLA ``("enter", "latent")``, ``x
      @ w_dkv``, then ``("enter", "query")``, ``x @ w_dq``, or
      ``("enter", "attn")`` for ``wq``) and ``("layer-grad", path)``, each
      layer slice's gradient brought to its holder over the row
      dimensions, last leaf first;
    * ``("grad", path)``: each leaf's gradient block summed over the row
      dimensions that do not split its layers.

    A rank whose leaves and rows no mesh dimension of more than one rank
    splits runs the plain loss: none."""
    P = dict(zip([p for p, _ in tree_paths(params_shape)],
                 _leaves(params_shape, param_specs, mesh)))
    sizes = next(iter(P.values())).sizes
    row_dims = [d for d in row_dims if sizes[d] > 1]
    if not row_dims and not any(
            sizes[m] > 1 for leaf in P.values() for ms in leaf.splits
            for m in ms):
        return []
    uses = {p: serve_use(cfg, p, s, mesh)
            for p, s in tree_paths(param_specs)}

    def use(path):
        return uses.get(path, "whole")
    m = mesh_axis_size(mesh, "model")
    isz = P["embed"].itemsize
    T = text + prefix
    act = rows * T * cfg.d_model * isz
    fwd, out = [], []
    if use("embed") == "vocab":
        fwd.append((("sum", "embed"), m * rows * text * cfg.d_model * isz,
                    m))
    blocks = [(p, leaf) for p, leaf in P.items() if p.startswith("blocks/")]
    layer, back = [], []
    for path, leaf in blocks:
        one = [1] + leaf.block[1:]
        slice_bytes = math.prod(one) * leaf.itemsize
        split = [d for d in reversed(leaf.splits[0]) if leaf.sizes[d] > 1]
        layer += [(("layer", path), leaf.sizes[d] * slice_bytes,
                   leaf.sizes[d]) for d in split]
        if uses[path] == "gather":
            layer += [(("whole", path), b, g) for b, g in
                      leaf.gather(range(1, len(leaf.shape)), one)]
        back = [(("layer-grad", path), leaf.sizes[d] * slice_bytes,
                 leaf.sizes[d]) for d in split if d in row_dims] + back
    attn_partial = use("blocks/attn/wo") == "rows"
    mlp_partial = use("blocks/mlp/w_down") in ("rows", "experts")
    shared_partial = use("blocks/mlp/shared/w_down") == "rows"
    if attn_partial:
        layer.append((("sum", "attn"), m * act, m))
    if mlp_partial or shared_partial:
        layer.append((("sum", "mlp"), m * act, m))
    enters = []
    if cfg.moe is not None:
        if shared_partial:
            enters.append((("enter", "shared"), m * act, m))
        if mlp_partial:
            enters.append((("enter", "router"),
                           m * rows * T * cfg.moe.top_k * 4, m))
            enters.append((("enter", "mlp"), m * act, m))
    elif mlp_partial:
        enters.append((("enter", "mlp"), m * act, m))
    if attn_partial and cfg.mla is not None:
        a = cfg.mla
        enters.append((("enter", "latent"), m * rows * T * (
            a.kv_lora_rank + a.qk_rope_head_dim) * isz, m))
        enters.append((("enter", "query"), m * rows * T * a.q_lora_rank
                       * isz, m) if a.q_lora_rank
                      else (("enter", "attn"), m * act, m))
    elif attn_partial:
        if use("blocks/attn/wk") != "cols":
            kv = m * rows * T * cfg.n_kv_heads * cfg.resolved_head_dim * isz
            enters += [(("enter", "v"), kv, m), (("enter", "k"), kv, m)]
        enters.append((("enter", "attn"), m * act, m))
    n_layers = blocks[0][1].shape[0] if blocks else 0
    vocab = use("embed") == "vocab"
    loss = [(("max", "logits"), m * rows * text * 4, m),
            (("sum", "lse"), m * rows * text * 4, m),
            (("sum", "label"), m * rows * text * 4, m)] if vocab else []
    out = fwd + layer * n_layers + loss
    if vocab:
        out.append((("enter", "head"), m * rows * text * cfg.d_model * isz,
                    m))
    out += (layer + enters + back) * n_layers
    for path, leaf in P.items():
        if not path.startswith("blocks/"):
            dims = row_dims
        else:
            dims = [d for d in row_dims if d not in leaf.splits[0]]
        out += [(("grad", path), sizes[d] * leaf.block_bytes, sizes[d])
                for d in dims]
    return out


def _row_dims(batch, batch_specs, mesh) -> list:
    tok = Leaf.of(batch["tokens"], batch_specs["tokens"], mesh)
    return [m for m in tok.splits[1] if tok.sizes[m] > 1]


def estimate_plan(cfg, mesh, state_shape, state_specs, batch, batch_specs
                  ) -> List[Tuple[Tuple[str, str], int, int]]:
    """:func:`train_gathers` of one agent's pass in a step of
    ``make_fed_step`` (its shapes and specs as :func:`fed_step_gathers`
    takes them): the agent's leaves, the rank's rows."""
    tok = Leaf.of(batch["tokens"], batch_specs["tokens"], mesh)
    one = [(p, t[0]) for p, t in tree_paths(state_shape.params)]
    specs = [PartitionSpec(*tuple(s)[1:])
             for _, s in tree_paths(state_specs.params)]
    text = batch["tokens"].shape[-1] - ("labels" not in batch)
    prefix = batch["prefix_embeds"].shape[2] if "prefix_embeds" in batch \
        else 0
    return train_gathers(cfg, _tree(one),
                         _tree(list(zip([p for p, _ in one], specs))), mesh,
                         tok.block[1], text, prefix,
                         _row_dims(batch, batch_specs, mesh))


def fed_step_gathers(fed, mesh, state_shape, state_specs, batch,
                     batch_specs, large: bool, coord=None, *, cfg
                     ) -> List[Gather]:
    """The collectives of one step of
    :func:`repro_torch.distributed.fed_trainer.make_fed_step` (``large``
    its PAGE coin) of ``cfg`` on the rank at mesh coordinate ``coord``
    (default all 0: the rank that enters every leaf's Gram partial), in
    order. ``state_shape`` and ``batch`` as tensors on any device
    (``meta``), ``state_specs`` from ``fed_state_shardings`` and
    ``batch_specs`` from ``batch_spec(stacked=True)``. The estimate's are
    :func:`train_gathers`' for each of the rank's agents (its ``params``
    pass, and on a PAGE step its ``prev`` pass), then its agents' losses
    summed over the row dimensions."""
    P = _leaves(state_shape.params, state_specs.params, mesh)
    coord = tuple(coord) if coord is not None else (0,) * len(P[0].sizes)
    K = P[0].shape[0]
    Kb = P[0].block[0]
    dims = sorted({m for leaf in P for m in leaf.trailing})
    out = []

    def owns(leaf):
        return all(coord[m] == 0 for m in dims if m not in leaf.trailing)

    def rows(leaf):
        return leaf.gather([0])

    def rank_sum(nbytes, over=dims):
        for m in over:
            g = P[0].sizes[m]
            if g > 1:
                out.append((nbytes * g, g))

    def agents(itemsize):
        out.extend(Leaf((K,), itemsize, P[0].sizes,
                        [P[0].splits[0]]).gather([0]))

    def gram():
        for leaf in P:
            if owns(leaf):
                out.extend(rows(leaf))
        rank_sum(K * K * 4)

    def each_rows():
        for leaf in P:
            out.extend(rows(leaf))

    # the estimate: each of the rank's agents' passes on its rows and
    # blocks, then the losses summed over the row dimensions
    plan = [(b, g) for _, b, g in estimate_plan(
        cfg, mesh, state_shape, state_specs, batch, batch_specs)]
    for _ in range(Kb):
        out.extend(plan * (1 if large else 2))
    if plan:
        rank_sum(Kb * 4, _row_dims(batch, batch_specs, mesh))
    agents(4)                                   # the f32 losses
    if K > 1:
        if fed.attack.name in ("avg_zero", "sign_flip"):
            each_rows()
        if fed.aggregator.name in ("krum", "rfa"):
            gram()
        each_rows()
    if fed.telemetry:
        rank_sum(Kb * P[0].itemsize)
        agents(P[0].itemsize)
    for f in state_shape.opt_state:
        leaves = [t for _, t in tree_paths(f)]
        if not (len(leaves) == len(P) and all(
                tuple(a.shape) == b.shape for a, b in zip(leaves, P))):
            agents(leaves[0].element_size())    # a per-agent counter
    if K > 1 and fed.kappa > 0:
        for _ in range(fed.kappa):
            gram()
            each_rows()
        gram()                                  # the diameter
    elif K > 1:
        gram()
    return out
