"""The port's analysis suite: the counterpart of the JAX package's
``repro.analysis``.

The reference checks JAX programs (jaxprs, XLA compile logs,
``donate_argnums``, ``memory_analysis()``); the port has no traced
programs, no compile cache and no donation, so each pass checks its
reference's intent on the port's eager code, generators and allocations:

* **Run passes** drive the port's real code small:
  :mod:`repro_torch.analysis.keycheck` (draw discipline: every draw from
  an explicit generator, no generator state drawn twice, fresh noise
  every step, one K-wide draw for the agents),
  :mod:`repro_torch.analysis.retrace` (config hygiene of the scenario
  keys; the kernel library built and loaded once per process),
  :mod:`repro_torch.analysis.donation` (caches written in place, steps
  that never write into their input state),
  :mod:`repro_torch.analysis.memcheck` (per-rank memory contracts of the
  D-sharded aggregators over gloo ranks).
* **AST lint** (:mod:`repro_torch.analysis.lint`) enforces the port's
  conventions on source text: spec strings resolve in the port's
  registry, explicit generators, kernels only behind ``kernels/``, host
  syncs marked in hot modules, no ``jax``/``repro`` import, no tracked
  smoke files.

Run everything with ``python -m repro_torch.analysis [--device cpu]``
(exit 1 on any finding), or single passes with ``--passes``. The package
imports ``torch``, numpy and the port only.
"""

from repro_torch.analysis.findings import Finding, render

__all__ = ["Finding", "render"]
