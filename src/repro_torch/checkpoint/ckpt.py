"""Dependency-free checkpointing of tensor pytrees: the port of the JAX
package's ``repro/checkpoint/ckpt.py``, with its npz layout.

An archive holds one array per leaf, named by the leaf's key path joined
by ``/`` (dict keys sorted, list and tuple indices, NamedTuple field
names: ``jax.tree_util``'s order and names), so an archive that either
package writes restores in the other. Writes are atomic (a temporary
sibling, then ``os.replace``), so a crash mid-write never leaves a torn
file.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tree import tree_map, tree_paths


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype (``torch.float32`` -> ``float32``),
    as the reference's messages print it."""
    return str(dtype).removeprefix("torch.")


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(tree, path: str) -> None:
    """Write ``tree``'s leaves (tensors on any device, numpy arrays or
    numbers) to ``path`` (``.npz`` appended when missing)."""
    path = _npz(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp-{os.getpid()}.npz"
    try:
        np.savez(tmp, **{k: _numpy(leaf) for k, leaf in tree_paths(tree)})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore(template, path: str, cast_dtypes: bool = False, device=None):
    """Restore into the structure of ``template``, a pytree of tensors
    (``device="meta"`` ones will do: only shapes and dtypes are read); the
    result's tensors lie on ``device`` (default CUDA, see
    :func:`repro_torch.resolve_device`).

    Structure, shape and dtype are validated *by key path* first, so a
    mismatched archive raises one ``ValueError`` naming every offending
    field (keys missing from the file, keys the template lacks, per-leaf
    shape and dtype deltas). ``cast_dtypes=True`` allows dtype-changing
    loads (e.g. an f32 file into a bf16 template), still shape-checked."""
    dev = resolve_device(device)
    flat = tree_paths(template)
    keys = [k for k, _ in flat]
    with np.load(_npz(path)) as data:
        arrays = {k: data[k] for k in data.files}
    problems = [f"{k}: in template but missing from file"
                for k in keys if k not in arrays]
    problems += [f"{k}: in file but not in template"
                 for k in sorted(set(arrays) - set(keys))]
    for k, leaf in flat:
        if k not in arrays:
            continue
        arr = arrays[k]
        if arr.shape != tuple(leaf.shape):
            problems.append(f"{k}: shape {arr.shape} != "
                            f"{tuple(leaf.shape)}")
        elif not cast_dtypes and torch.from_numpy(arr).dtype != leaf.dtype:
            problems.append(f"{k}: dtype {arr.dtype} != "
                            f"{_dtype_name(leaf.dtype)} "
                            f"(cast_dtypes=True to allow)")
    if problems:
        raise ValueError(
            f"checkpoint {path!r} does not match the restore template "
            f"({len(problems)} field(s)): " + "; ".join(problems))
    loaded = iter([torch.from_numpy(arrays[k]).to(device=dev,
                                                  dtype=leaf.dtype)
                   for k, leaf in flat])
    return tree_map(lambda _: next(loaded), template)

