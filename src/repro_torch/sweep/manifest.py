"""Sweep manifest: the on-disk record that makes a windowed grid run
resumable. The port of the JAX package's ``repro/sweep/manifest.py``,
with its layout, so the two packages' sweep directories read alike.

Layout of a sweep directory::

    manifest.json            static sweep description, written once:
                             version, meta (algo/env/T/seeds/axes/base —
                             everything needed to reconstruct the grid —
                             and the device type the runs drew on),
                             the window slices, and one entry per group
                             (gid, lane count, rows, pad rows,
                             signature string, scenario names)
    groupNNN.state.json      per-group progress: {"windows_done": w,
                             "t_done": t} — committed *after* the carry
                             and chunk for window w-1 land on disk
    groupNNN.carry.npz       the group's carry stack after its last
                             committed window, with the rows' generator
                             states (repro_torch.checkpoint format)
    groupNNN.winMMM.npz      window M's history chunk (flat dict of
                             arrays, time axis 1)
    summary.json             final ``ExperimentResult.to_json`` document,
                             written when every group completes

All JSON/npz writes are atomic (temp sibling + ``os.replace``), and the
state file is committed last, so a crash at any point leaves either a
fully committed window or a cleanly re-runnable one — never a torn
resume point.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

MANIFEST = "manifest.json"
SUMMARY = "summary.json"
VERSION = 1


class SweepMismatch(ValueError):
    """A resume directory's manifest disagrees with the requested sweep;
    the message names every differing field."""


def write_json(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class GroupPaths:
    """File names for one group's artifacts under a sweep dir."""
    out_dir: str
    gid: int

    @property
    def stem(self) -> str:
        return os.path.join(self.out_dir, f"group{self.gid:03d}")

    @property
    def state(self) -> str:
        return self.stem + ".state.json"

    @property
    def carry(self) -> str:
        return self.stem + ".carry.npz"

    def window(self, w: int) -> str:
        return self.stem + f".win{w:03d}.npz"


def windows_done(paths: GroupPaths) -> int:
    """Committed window count for a group (0 when it never started)."""
    if not os.path.exists(paths.state):
        return 0
    return int(read_json(paths.state).get("windows_done", 0))


def commit_window(paths: GroupPaths, windows_done: int, t_done: int) \
        -> None:
    """Mark ``windows_done`` windows committed — call only after the
    matching carry + chunk files are on disk (write ordering is the
    crash-safety contract)."""
    write_json(paths.state, {"windows_done": int(windows_done),
                             "t_done": int(t_done)})


def build_manifest(meta: dict, slices, group_entries) -> dict:
    """The static sweep description (see module docstring)."""
    return {"version": VERSION, "meta": meta,
            "window_slices": [list(s) for s in slices],
            "groups": list(group_entries)}


def check_manifest(on_disk: dict, wanted: dict) -> None:
    """Raise :class:`SweepMismatch` naming every field where the resumed
    directory's manifest disagrees with the sweep being requested."""
    problems = []
    if on_disk.get("version") != wanted["version"]:
        problems.append(f"version: {on_disk.get('version')} != "
                        f"{wanted['version']}")
    old_meta, new_meta = on_disk.get("meta", {}), wanted["meta"]
    for k in sorted(set(old_meta) | set(new_meta)):
        if old_meta.get(k) != new_meta.get(k):
            problems.append(f"meta.{k}: {old_meta.get(k)!r} != "
                            f"{new_meta.get(k)!r}")
    if on_disk.get("window_slices") != wanted["window_slices"]:
        problems.append(
            f"window_slices: {on_disk.get('window_slices')} != "
            f"{wanted['window_slices']}")
    old_g, new_g = on_disk.get("groups", []), wanted["groups"]
    if len(old_g) != len(new_g):
        problems.append(f"group count: {len(old_g)} != {len(new_g)}")
    else:
        for og, ng in zip(old_g, new_g):
            for k in ("gid", "signature", "lanes", "rows", "n_pad"):
                if og.get(k) != ng.get(k):
                    problems.append(
                        f"group {ng.get('gid')}.{k}: {og.get(k)!r} != "
                        f"{ng.get(k)!r}")
    if problems:
        raise SweepMismatch(
            "resume directory manifest does not describe this sweep "
            f"({len(problems)} field(s)): " + "; ".join(problems))


def load_or_init(out_dir: str, wanted: dict, write: bool = True) \
        -> Optional[dict]:
    """Validate an existing ``manifest.json`` against ``wanted`` (raising
    :class:`SweepMismatch` on disagreement) or write ``wanted`` as the new
    manifest (when ``write``; multi-process readers pass False and wait
    for the writer).  Returns the on-disk manifest, or None when absent
    and not written."""
    path = os.path.join(out_dir, MANIFEST)
    if os.path.exists(path):
        doc = read_json(path)
        check_manifest(doc, wanted)
        return doc
    if write:
        write_json(path, wanted)
        return wanted
    return None
