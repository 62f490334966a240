"""Phase discipline rules (PHASE0xx).

The invariant: every wire byte is booked to exactly one phase
("offline" or "online") via the round scope that encloses the send, and
once the offline executor seals a store, the online half must never move
offline-phase traffic — enforced dynamically by
``MeasuredTransport.forbid_phase`` and statically here.
"""
from __future__ import annotations

import ast

from .core import (Module, Rule, call_name, const_str, is_protocol_module,
                   kwarg, register)

# Modules that own the phase lifecycle and may legitimately re-open a
# forbidden phase (executor's run_online finally, cluster task teardown)
# or implement the machinery itself.
_ALLOW_PHASE_OWNERS = (
    "runtime/transport.py",
    "offline/executor.py",
    "runtime/net/cluster.py",
)


def _enclosing_round_phases(mod: Module, node: ast.AST) -> list:
    """String literals of every ``with *.round("...")`` enclosing node."""
    phases = []
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and call_name(ctx).endswith(".round"):
                    p = const_str(ctx.args[0]) if ctx.args else None
                    phases.append(p)
    return phases


@register
class PhaseMismatchInRound(Rule):
    id = "PHASE001"
    name = "phase-mismatch-in-round"
    doc = ("A send with a literal phase tag inside a `with *.round(...)` "
           "scope must use the same phase as the scope, or the byte is "
           "booked to the wrong ledger.")

    def check(self, module: Module) -> list:
        out = []
        for call in module.calls:
            if not call_name(call).endswith(".send"):
                continue
            sent = const_str(kwarg(call, "phase"))
            if sent is None:
                continue
            scopes = [p for p in _enclosing_round_phases(module, call)
                      if p is not None]
            if scopes and sent not in scopes:
                out.append(module.finding(
                    self.id, call,
                    f"send(phase={sent!r}) inside a round scope opened for "
                    f"phase {scopes[0]!r}"))
        return out


@register
class PhaseSendOutsideRound(Rule):
    id = "PHASE002"
    name = "send-outside-round-scope"
    doc = ("In protocol modules, a send with a *literal* phase tag must be "
           "lexically inside a `with *.round(...)` scope.  Helpers taking "
           "the phase as a parameter inherit the caller's scope and are "
           "exempt.")

    def applies(self, relpath: str) -> bool:
        return is_protocol_module(relpath)

    def check(self, module: Module) -> list:
        out = []
        for call in module.calls:
            if not call_name(call).endswith(".send"):
                continue
            sent = const_str(kwarg(call, "phase"))
            if sent is None:
                continue  # phase threaded from a parameter: caller-scoped
            if not _enclosing_round_phases(module, call):
                out.append(module.finding(
                    self.id, call,
                    f"send(phase={sent!r}) outside any round scope; wrap in "
                    f"`with tp.round({sent!r}, ...)`"))
        return out


@register
class PhaseBypass(Rule):
    id = "PHASE003"
    name = "forbid-phase-bypass"
    doc = ("`allow_phase` re-opens a sealed phase and belongs only to the "
           "lifecycle owners (transport itself, the offline executor's "
           "run_online teardown, cluster task teardown).  Writing "
           "`_forbidden` directly is never allowed outside transport.py.")

    def check(self, module: Module) -> list:
        if module.relpath in _ALLOW_PHASE_OWNERS:
            return []
        out = []
        for call in module.calls:
            if call_name(call).endswith(".allow_phase"):
                out.append(module.finding(
                    self.id, call,
                    "allow_phase() bypasses forbid_phase outside a "
                    "lifecycle-owner module"))
        for node in module.nodes:
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Attribute) and t.attr == "_forbidden":
                        out.append(module.finding(
                            self.id, node,
                            "direct write to transport._forbidden outside "
                            "transport.py"))
        return out
