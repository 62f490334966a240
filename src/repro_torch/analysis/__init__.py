"""tridentlint over the port: the protocol-invariant static analyzer and
concurrency audit (``repro/analysis``), run over ``src/repro_torch``.

Rule families (the 13 ids and names of ``docs/ANALYSIS.md``):

* PREP0xx — prep-seam discipline (randomness only via prep.acquire)
* PHASE0x — phase discipline (round scopes, forbid_phase bypasses)
* OBS0xx  — observability-seam coverage (traced protocols, byte booking)
* CONC0xx — concurrency audit (lock graphs, shared attrs, thread hygiene)

The rules are the JAX package's, twinned where the port's idiom differs:
PREP001 also knows the port's samplers (``sample_group``,
``lambda_masks_group``, torch's RNG), and the concurrency audit also
covers three port modules that take a lock or a thread-local (the
tracer, the kernel loader, the PRF wrapper).  Findings keep the ``(rule,
file, anchor)`` key and baseline format version 1, so an entry of
``analysis/baseline_torch.json`` reads like one of
``analysis/baseline.json``.

The analyzer reads source with stdlib ``ast`` only: it has no device and
no entry point that runs on the card, so the port's "CUDA unless the
caller asks for the CPU" does not apply to it.
"""
from .baseline import diff as baseline_diff, load as baseline_load, \
    save as baseline_save
from .core import (Finding, Module, Rule, all_rules, load_tree, register,
                   run_rules)

__all__ = [
    "Finding", "Module", "Rule", "all_rules", "load_tree", "register",
    "run_rules", "baseline_diff", "baseline_load", "baseline_save",
]
