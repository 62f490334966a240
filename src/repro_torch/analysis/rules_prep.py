"""Prep-seam discipline rules (PREP0xx).

The invariant: runtime protocols draw every piece of
data-independent randomness through ``rt.prep.acquire(tag, kind, build)``
so that dealing (DealPrep) and consuming (OnlinePrep) replay the exact
same tag sequence.  Direct PRF sampling inside a protocol body bypasses
the seam and silently diverges the deal/consume transcripts.

Sanctioned sampling contexts, in order of checking:

1. inside a *build function* — a nested def (or lambda) passed as an
   argument to a ``*.acquire(...)`` call;
2. under a branch of an ``if`` whose test mentions ``prep.consuming``
   (the explicit two-halves pattern used by ``_bit_extract_mul``);
3. inside a module-level helper whose every call site is itself a
   sanctioned context (fixpoint) — the ``_gamma_exchange`` /
   ``_vsh_lam_parts`` offline-half helpers.

Anything else is PREP001.  PREP002 guards tag parity: prep tags must be
allocated unconditionally, never under a prep-mode conditional, or the
deal and consume transcripts disagree on the tag stream.

The port draws through ``rt.sample_group`` (one PRF kernel launch a group
of draws, ``runtime/runtime.py``; the joint context's twin in
``core/context.py``) and the kernel wrapper ``ops.lambda_masks_group``,
and could reach for torch's RNG: PREP001 knows those samplers besides
every name the JAX rule knows, so it flags at least what the JAX rule
flags.
"""
from __future__ import annotations

import ast

from .core import (Module, Rule, call_name, dotted_name, is_protocol_module,
                   register)

# Call-name suffixes that mint randomness outside the seam: the JAX
# rule's, the port's grouped samplers, and torch's in-place samplers.
_SAMPLING_SUFFIXES = (".sample", ".sample_bounded", ".squares_stream",
                      ".sample_group", ".lambda_masks_group",
                      ".random_", ".uniform_", ".normal_")
_SAMPLING_PREFIXES = ("np.random.", "numpy.random.", "nprand.")
_SAMPLING_EXACT = ("jax.random.PRNGKey", "jax.random.key", "random.PRNGKey",
                   "jrandom.PRNGKey", "jrandom.key", "squares_stream",
                   "torch.rand", "torch.randint", "torch.randn",
                   "torch.randperm", "torch.normal", "torch.bernoulli",
                   "torch.multinomial", "torch.Generator",
                   "torch.manual_seed", "torch.rand_like",
                   "torch.randint_like", "torch.randn_like")


def _is_sampling_call(call: ast.Call) -> bool:
    name = call_name(call)
    if not name:
        return False
    if name in _SAMPLING_EXACT:
        return True
    if any(name.startswith(p) for p in _SAMPLING_PREFIXES):
        return True
    return any(name.endswith(s) for s in _SAMPLING_SUFFIXES)


def _mentions_consuming(test: ast.expr) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr == "consuming":
            return True
    return False


def _build_function_names(mod: Module) -> set:
    """Names passed as arguments to any ``*.acquire(...)`` call."""
    names = set()
    for call in mod.calls:
        if call_name(call).endswith(".acquire"):
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                if isinstance(arg, ast.Name):
                    names.add(arg.id)
    return names


def _in_sanctioned_context(mod: Module, node: ast.AST, builds: set) -> bool:
    """Checks contexts (1) and (2); context (3) is the caller's fixpoint."""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.If) and _mentions_consuming(anc.test):
            return True
        if isinstance(anc, ast.Lambda):
            par = mod.parent(anc)
            if isinstance(par, ast.Call) and call_name(par).endswith(".acquire"):
                return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if anc.name in builds and mod.enclosing_function(anc) is not None:
                return True  # nested def handed to acquire
    return False


@register
class PrepSamplingOutsideSeam(Rule):
    id = "PREP001"
    name = "sampling-outside-prep-seam"
    doc = ("Direct PRF sampling in a protocol body must happen inside a "
           "prep.acquire build, under a prep.consuming guard, or in a "
           "helper reachable only from such contexts.")

    def applies(self, relpath: str) -> bool:
        return is_protocol_module(relpath)

    def check(self, module: Module) -> list:
        builds = _build_function_names(module)

        def enclosing_top(node: ast.AST):
            top = None
            for anc in module.ancestors(node):
                if (isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and module.enclosing_function(anc) is None):
                    top = anc.name
            return top

        # Context (3), greatest fixpoint: a top-level function is
        # *offline-only* iff it is itself a build handed to acquire, or
        # every in-module call to it happens in a sanctioned context or
        # inside another offline-only function.  Public entries (no
        # in-module callers) are never offline-only — they run online.
        top_fns = {n.name for n in module.tree.body
                   if isinstance(n, ast.FunctionDef)}
        call_sites = {}  # fn name -> list of (sanctioned_12, enclosing_top)
        for call in module.calls:
            fn = call_name(call)
            if fn in top_fns:
                call_sites.setdefault(fn, []).append(
                    (_in_sanctioned_context(module, call, builds),
                     enclosing_top(call)))

        offline_only = set(top_fns)
        changed = True
        while changed:
            changed = False
            for fn in list(offline_only):
                if fn in builds:
                    continue  # handed to acquire: sanctioned axiomatically
                sites = call_sites.get(fn, [])
                ok = bool(sites) and all(
                    ctx12 or (top is not None and top in offline_only)
                    for ctx12, top in sites)
                if not ok:
                    offline_only.discard(fn)
                    changed = True

        out = []
        for call in module.calls:
            if not _is_sampling_call(call):
                continue
            if _in_sanctioned_context(module, call, builds):
                continue
            top = enclosing_top(call)
            if top is None or top not in offline_only:
                out.append(module.finding(
                    self.id, call,
                    f"`{call_name(call)}` samples outside the prep.acquire "
                    "seam (not in a build, consuming-guard, or build-only "
                    "helper)"))
        return out


@register
class PrepTagParity(Rule):
    id = "PREP002"
    name = "prep-tag-parity"
    doc = ("prep.acquire / next_tag must run unconditionally: allocating a "
           "tag under a prep-mode conditional desynchronises the deal and "
           "consume tag streams.")

    _MODE_ATTRS = ("consuming", "skip_online", "mode")

    def applies(self, relpath: str) -> bool:
        return is_protocol_module(relpath)

    def _mode_conditional(self, test: ast.expr) -> bool:
        for node in ast.walk(test):
            if isinstance(node, ast.Attribute) and node.attr in self._MODE_ATTRS:
                if "prep" in dotted_name(node):
                    return True
            if isinstance(node, ast.Name) and node.id in self._MODE_ATTRS:
                return True
        return False

    def check(self, module: Module) -> list:
        out = []
        for call in module.calls:
            name = call_name(call)
            if not (name.endswith(".prep.acquire") or name.endswith(".next_tag")):
                continue
            # a next_tag nested as an argument of a flagged acquire is the
            # same violation: report the acquire only
            if name.endswith(".next_tag") and any(
                    isinstance(a, ast.Call)
                    and call_name(a).endswith(".prep.acquire")
                    for a in module.ancestors(call)):
                continue
            for anc in module.ancestors(call):
                if isinstance(anc, ast.If) and self._mode_conditional(anc.test):
                    out.append(module.finding(
                        self.id, call,
                        f"`{name}` allocates a prep tag under a prep-mode "
                        "conditional; tags must be minted in all modes"))
                    break
        return out
