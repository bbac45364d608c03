"""Shared finding type for the port's analysis passes: the port's own copy
of the JAX package's ``analysis/findings.py``.

Every pass (the draw recorder, the config and build audits, the state
contracts, the memory contracts, the AST lint) reports problems as
:class:`Finding` records with a file/line anchor, so the CLI and the tests
treat all passes alike: a pass is a callable returning ``list[Finding]``,
and an empty list means the contract holds.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation.

    ``pass_name`` is the reporting pass (``keycheck``, ``retrace``,
    ``donation``, ``memcheck``, ``lint``); ``rule`` the specific contract
    within it. ``path``/``line`` anchor the violation: for the draw
    recorder the line of the draw's innermost frame outside torch, for the
    lint the AST node. ``line`` may be 0 when no source location applies
    (e.g. a whole-program contract).
    """

    pass_name: str
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.pass_name}/{self.rule}] {self.message}"


def render(findings: Iterable[Finding]) -> str:
    return "\n".join(f.format() for f in findings)
