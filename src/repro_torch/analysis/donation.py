"""State contracts of the port's steps: the counterpart of the JAX
package's ``analysis/donation.py``.

The reference audits that every ``donate_argnums`` site fully aliases, so
a state update does not double memory. PyTorch runs eagerly and donates
nothing; what carries over is each site's contract, of one of two kinds:

* **in-place** (``serving_decode``, ``serving_tick``,
  ``serving_insert``): the decode cache is written where it lies. Every
  buffer of the cache (each leaf of ``blocks``: the ring and the
  recurrent states, and ``slot_pos``) comes back at the same
  ``data_ptr()``; ``pos``, the step counter of one integer a row, is
  returned anew, as ``decode_step`` documents. And no allocation of a
  buffer's size happens during the call: the peak of the bytes allocated
  during it (:class:`~repro_torch.analysis.memcheck.LiveBytes`) stays
  below the smallest leaf of ``blocks`` (the ``bound``). A decode step's
  own temporaries are one layer's: its ring gathered for attention (at
  most 2·B·W·H_kv·hd·4 bytes, 2/L of a K or V leaf), its activations and
  the logits (B·V·4), so a fresh copy of any buffer crosses the bound
  where L > 2 and the ring is long beside B·V; the sites are sized so.
* **functional** (``fused_decbyzpg``/``fused_byzpg``: the window
  functions, ``fed_train_window``, ``make_fed_step``): a step never
  writes into the state it is given. Every input tensor's ``_version``
  is unchanged, and so is a per-leaf checksum (the int64 sum of its bits,
  computed on its device: no host copy of the state).

Each :class:`Site` keeps the reference's name, and names its function by
import path (``module:qualname``); a function that no longer resolves is
a ``site-drift`` finding, and the site is not run. Rules: ``site-drift``,
``moved-buffer``, ``buffer-sized-allocation`` (in-place),
``input-written``, ``input-changed`` (functional).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import keystr, tree_flatten_with_path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.memcheck import LiveBytes, free_port

IN_PLACE = "in-place"
FUNCTIONAL = "functional"


@dataclasses.dataclass(frozen=True)
class Site:
    """One state contract: the reference's site name, the source file,
    the function it is about (``module:qualname``), its kind, and a
    function ``(device) -> Call`` making a small call through it."""
    name: str
    path: str
    target: str
    kind: str
    build: Callable


@dataclasses.dataclass
class Call:
    """One audited call ``fn()``. ``state``: for an in-place site the
    buffers written in place (``out_state(result)`` gives them back, in
    the same tree) and ``bound`` the bytes no allocation may reach; for a
    functional site every input (a tree; its tensors are checked).
    ``close`` releases what the call needed (a process group)."""
    fn: Callable
    state: object
    out_state: Optional[Callable] = None
    bound: Optional[int] = None
    close: Callable = lambda: None


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)        # a DTensor's block


def _leaves(tree) -> list:
    """(path, tensor) for every tensor leaf, a DTensor as its block."""
    return [(keystr(p), _local(x)) for p, x in tree_flatten_with_path(tree)[0]
            if isinstance(x, torch.Tensor)]


#: elements summed at a time: an int64 sum widens its input first, so a
#: leaf of gigabytes is summed in slices of 128 MB of int64
CHECKSUM_CHUNK = 1 << 24


def checksum(t: torch.Tensor) -> torch.Tensor:
    """The int64 sum of ``t``'s bits as integers of its width, on its
    device (wrapping, so equal bits give equal sums on any device)."""
    x = t.detach().contiguous().view(-1)
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[x.element_size()]
    x = x.view(width)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, x.numel(), CHECKSUM_CHUNK):
        total += torch.sum(x[lo:lo + CHECKSUM_CHUNK], dtype=torch.int64)
    return total


def check_call(name: str, kind: str, call: Call, device,
               path: str = "") -> tuple:
    """Run ``call`` under its contract: ``(findings, report)``, the report
    holding the peak bytes allocated during the call and its bound."""
    findings = []

    def bad(rule, msg):
        findings.append(Finding("donation", rule, path or name, 0,
                                f"[{name}] {msg}"))

    dev = torch.device(device)
    leaves = _leaves(call.state)
    if kind == IN_PLACE:
        ptrs = {p: t.data_ptr() for p, t in leaves}
        with LiveBytes(dev) as mem:
            result = call.fn()
        back = dict(_leaves(call.out_state(result)))
        moved = [p for p in ptrs
                 if p not in back or back[p].data_ptr() != ptrs[p]]
        if moved:
            bad("moved-buffer",
                f"buffers {moved[:4]} came back at another address — the "
                f"cache is written in place, never copied")
        if mem.peak >= call.bound:
            bad("buffer-sized-allocation",
                f"{mem.peak} bytes were allocated during the call, at least "
                f"the smallest buffer's {call.bound}: a fresh copy of the "
                f"state, where it is written in place")
        return findings, dict(site=name, kind=kind, peak=mem.peak,
                              bound=call.bound)
    versions = [t._version for _, t in leaves]
    sums = torch.stack([checksum(t).to(dev) for _, t in leaves])
    with LiveBytes(dev) as mem:
        call.fn()
    written = [p for (p, t), v in zip(leaves, versions) if t._version != v]
    after = torch.stack([checksum(t).to(dev) for _, t in leaves])
    changed = [leaves[i][0]
               for i in torch.nonzero(sums != after).flatten().tolist()]
    if written:
        bad("input-written",
            f"the call wrote into its inputs {written[:4]} — a step never "
            f"writes into the state it is given")
    if changed:
        bad("input-changed",
            f"the bits of inputs {changed[:4]} changed during the call")
    return findings, dict(site=name, kind=kind, peak=mem.peak, bound=None,
                          inputs=len(leaves))


def _resolve(target: str):
    mod, _, qual = target.partition(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def check_site(site: Site, device="cpu", report: Optional[list] = None
               ) -> list:
    try:
        _resolve(site.target)
    except (ImportError, AttributeError) as e:
        return [Finding("donation", "site-drift", site.path, 0,
                        f"[{site.name}] {site.target} does not resolve "
                        f"({e}) — update the site table of "
                        f"repro_torch.analysis.donation")]
    call = site.build(device)
    try:
        findings, rep = check_call(site.name, site.kind, call, device,
                                   site.path)
    finally:
        call.close()
    if report is not None:
        report.append(rep)
    return findings


# ---------------------------------------------------------------------------
# Site table
# ---------------------------------------------------------------------------


def buffers(cache: dict) -> dict:
    """The buffers of a decode cache that its steps write in place."""
    return {"blocks": cache["blocks"], "slot_pos": cache["slot_pos"]}


def smallest_block(cache: dict) -> int:
    return min(t.nbytes for _, t in _leaves(cache["blocks"]))


def _algo_site(algo: str, device) -> Call:
    from repro_torch.core.engine import seed_generator
    from repro_torch.core.registry import resolve
    from repro_torch.rl.envs import make_env
    env = make_env("cartpole(horizon=12)")
    a = resolve("algo", algo)
    kw = dict(agreement="gda", kappa=1) if algo == "decbyzpg" else {}
    cfg = a.config_cls(K=3, n_byz=1, N=3, B=2, hidden=(8,), **kw)
    gen = seed_generator(0, device)
    carry = a.init(env, cfg, gen, device=device)
    return Call(lambda: a.window(env, cfg, carry, gen, 0, 2), carry)


def _model(layers: int = 2):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("llama3.2-1b")),
                               n_layers=layers)


def _fed_inputs(device, K: int = 2, W: int = 2):
    from repro_torch.core.engine import seed_generator
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed.fed_trainer import FedConfig, init_fed_state
    cfg = _model()
    fed = FedConfig(aggregator="rfa", kappa=1, n_byz=0)
    gen = seed_generator(0, device)
    state = init_fed_state(cfg, fed, K, gen, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    per_agent_batch=2, n_agents=K),
                         device=device)
    batches = [pipe.batch(t) for t in range(W)]
    mask = torch.zeros((K,), dtype=torch.bool, device=device)
    return cfg, fed, gen, state, batches, mask


def _fed_window_site(device) -> Call:
    from repro_torch.distributed.fed_trainer import fed_train_window
    cfg, fed, gen, state, batches, mask = _fed_inputs(device)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    return Call(lambda: fed_train_window(cfg, fed, state, stacked, mask,
                                         range(len(batches)), gen),
                (state, stacked, mask))


@contextlib.contextmanager
def one_rank_mesh(device_type: str):
    """A one-rank ("data", "model") = (1, 1) mesh: in the process group
    when one is joined, else in a gloo group of this process alone, left
    on exit (gloo: a mesh of one rank launches no collective, and the
    process keeps its card free of NCCL's buffers)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (init_distributed,
                                                  leave_distributed)
    from repro_torch.launch.mesh import make_debug_mesh
    own = not dist.is_initialized()
    if own:
        init_distributed(f"localhost:{free_port()}", 1, 0,
                         device=device_type, backend="gloo",
                         group_of_one=True)
    try:
        yield make_debug_mesh(1, 1, device_type=device_type)
    finally:
        if own:
            leave_distributed()


def _fed_step_site(device) -> Call:
    from repro_torch.distributed.fed_trainer import make_fed_step
    cfg, fed, _, state, batches, mask = _fed_inputs(device)
    stack = contextlib.ExitStack()
    mesh = stack.enter_context(one_rank_mesh(torch.device(device).type))
    # the PAGE step (large=False) reads every field of the state
    step = make_fed_step(cfg, fed, mesh, large=False, per_agent_batch=2,
                         seq_len=16)[0]
    return Call(lambda: step(state, batches[0], mask),
                (state, batches[0], mask), close=stack.close)


def _serve_cfg():
    # eight layers: a step's temporaries are one layer's, far below a
    # stacked (L, ...) buffer
    return _model(layers=8)


def _params(cfg, device):
    from repro_torch.core.engine import seed_generator
    from repro_torch.models.model import init_params
    return init_params(cfg, seed_generator(0, device), device=device)


def _serving_decode_site(device) -> Call:
    from repro_torch.distributed.serving import make_serve_fns
    cfg = _serve_cfg()
    params = _params(cfg, device)
    stack = contextlib.ExitStack()
    mesh = stack.enter_context(one_rank_mesh(torch.device(device).type))
    fns = make_serve_fns(cfg, mesh, batch=2, seq_len=64)
    tokens = torch.arange(16, device=device).reshape(2, 8) % cfg.vocab_size
    logits, cache = fns.prefill(params, tokens)
    tok = torch.argmax(logits[:, -1], dim=-1)
    return Call(lambda: fns.decode(params, tok, cache), buffers(cache),
                lambda r: buffers(r[1]), smallest_block(cache),
                close=stack.close)


def _engine(device):
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.request import Request
    cfg = _serve_cfg()
    engine = DecodeEngine(cfg, _params(cfg, device), slots=2, max_new=16,
                          max_prompt=48, device=device)
    req = Request(uid=0, max_new=8, tokens=np.arange(5, dtype=np.int32))
    return engine, engine.init_state(), engine.prefill_request(req)


def _serving_tick_site(device) -> Call:
    engine, state, (first, row, total) = _engine(device)
    state = engine.insert(state, 0, row, first, total, 8)
    return Call(lambda: engine.tick(state), buffers(state.cache),
                lambda r: buffers(r[0].cache), smallest_block(state.cache))


def _serving_insert_site(device) -> Call:
    engine, state, (first, row, total) = _engine(device)
    return Call(lambda: engine.insert(state, 1, row, first, total, 8),
                buffers(state.cache), lambda r: buffers(r.cache),
                smallest_block(state.cache))


def sites() -> list:
    return [
        Site("fused_decbyzpg", "src/repro_torch/core/decbyzpg.py",
             "repro_torch.core.decbyzpg:window_decbyzpg", FUNCTIONAL,
             lambda d: _algo_site("decbyzpg", d)),
        Site("fused_byzpg", "src/repro_torch/core/byzpg.py",
             "repro_torch.core.byzpg:window_byzpg", FUNCTIONAL,
             lambda d: _algo_site("byzpg", d)),
        Site("fed_train_window", "src/repro_torch/distributed/fed_trainer.py",
             "repro_torch.distributed.fed_trainer:fed_train_window",
             FUNCTIONAL, _fed_window_site),
        Site("make_fed_step", "src/repro_torch/distributed/fed_trainer.py",
             "repro_torch.distributed.fed_trainer:make_fed_step", FUNCTIONAL,
             _fed_step_site),
        Site("serving_decode", "src/repro_torch/distributed/serving.py",
             "repro_torch.distributed.serving:make_serve_fns", IN_PLACE,
             _serving_decode_site),
        Site("serving_tick", "src/repro_torch/serving/engine.py",
             "repro_torch.serving.engine:DecodeEngine.tick", IN_PLACE,
             _serving_tick_site),
        Site("serving_insert", "src/repro_torch/serving/engine.py",
             "repro_torch.serving.engine:DecodeEngine.insert", IN_PLACE,
             _serving_insert_site),
    ]


def run(device="cpu", report: Optional[list] = None) -> list:
    findings = []
    for site in sites():
        findings.extend(check_site(site, device, report))
    return findings
