"""DecByzPG and ByzPG core: registry, attacks, aggregation, agreement,
the steps, PAGE, and the experiment engine.

The reference's package-level names, resolved lazily (PEP 562) as the
reference's are, so importing one submodule (``repro_torch.core.
registry``, which leaf modules such as ``repro_torch.optim.optimizers``
depend on) does not pull in the whole algorithm stack. Each name is the
port's own form: ``get_aggregator`` returns an aggregator called with the
receivers' permutations where the reference's takes a key, and
``run_decbyzpg``/``run_byzpg`` take ``device=``. ``run_decbyzpg_legacy``
and ``run_byzpg_legacy`` (the reference's jit-dispatch harnesses) are not
carried, on purpose: the port has no jit dispatch to compare against.
"""
import importlib

_EXPORTS = {
    "get_aggregator": "repro_torch.core.aggregators",
    "avg_agree": "repro_torch.core.agreement",
    "gda_mean": "repro_torch.core.agreement",
    "honest_diameter": "repro_torch.core.agreement",
    "mda_mean": "repro_torch.core.agreement",
    "get_attack": "repro_torch.core.attacks",
    "is_env_level": "repro_torch.core.attacks",
    "per_receiver": "repro_torch.core.attacks",
    "ByzPGConfig": "repro_torch.core.byzpg",
    "run_byzpg": "repro_torch.core.byzpg",
    "DecByzPGConfig": "repro_torch.core.decbyzpg",
    "run_decbyzpg": "repro_torch.core.decbyzpg",
    "Experiment": "repro_torch.core.engine",
    "ExperimentResult": "repro_torch.core.engine",
    "Scenario": "repro_torch.core.engine",
    "ScenarioGrid": "repro_torch.core.engine",
    "run_grid": "repro_torch.core.engine",
    "REGISTRY": "repro_torch.core.registry",
    "Spec": "repro_torch.core.registry",
    "SpecError": "repro_torch.core.registry",
    "register": "repro_torch.core.registry",
    "resolve": "repro_torch.core.registry",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch.core' has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
