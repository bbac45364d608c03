"""``python -m repro_torch.analysis`` — run the port's analysis suite.

Runs every pass (or a ``--passes`` subset) on ``--device`` (default
CUDA, through :func:`repro_torch.resolve_device`, which raises without a
card; ``--device cpu`` runs the plain versions), prints findings as
``path:line: [pass/rule] message`` and exits 1 iff any pass found
anything. The passes are unit-tested against deliberately broken fixtures
in ``tests/test_torch_analysis_*.py``.

Passes
------
* ``lint``      AST lint of the port (spec strings, explicit generators,
                kernel location, host syncs in hot modules, reference
                imports, smoke files)
* ``keycheck``  draw discipline over the real entry points, run small
* ``retrace``   config hygiene + build-once over a swept grid
* ``donation``  in-place and functional state contracts of the steps
* ``memcheck``  per-rank memory contracts of the D-sharded aggregators
                over gloo ranks
"""

from __future__ import annotations

import argparse
import sys
import time


def _pass_lint(device):
    from repro_torch.analysis import lint
    return lint.run()


def _pass_keycheck(device):
    from repro_torch.analysis import keycheck
    return keycheck.run(device)


def _pass_retrace(device):
    from repro_torch.analysis import retrace
    return retrace.run(device)


def _pass_donation(device):
    from repro_torch.analysis import donation
    return donation.run(device)


def _pass_memcheck(device):
    from repro_torch.analysis import memcheck
    return memcheck.run(device)


# cheap/pure passes first so a lint failure reports before the slow
# passes run
PASSES = {
    "lint": _pass_lint,
    "keycheck": _pass_keycheck,
    "retrace": _pass_retrace,
    "donation": _pass_donation,
    "memcheck": _pass_memcheck,
}


def main(argv=None) -> int:
    from repro_torch import resolve_device
    from repro_torch.analysis.findings import render
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis suite (see repro_torch.analysis)")
    parser.add_argument(
        "--passes", default=",".join(PASSES),
        help="comma-separated subset of: " + ", ".join(PASSES))
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    names = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = [p for p in names if p not in PASSES]
    if unknown:
        parser.error(f"unknown pass(es): {', '.join(unknown)}")
    device = resolve_device(args.device)

    all_findings = []
    for name in names:
        t0 = time.monotonic()
        findings = PASSES[name](device)
        dt = time.monotonic() - t0
        status = "ok" if not findings else f"{len(findings)} finding(s)"
        print(f"[analysis] {name:<9} {status} ({dt:.1f}s)", file=sys.stderr)
        all_findings.extend(findings)
    if all_findings:
        print(render(all_findings))
        return 1
    print(f"[analysis] clean: {len(names)} pass(es), 0 findings",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
