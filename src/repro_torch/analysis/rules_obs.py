"""Observability-seam rules (OBS0xx).

The invariant: every public protocol entry point is visible to
the tracer and the metrics registry through ``@traced_protocol`` (the
decorator bumps ``trident_protocol_calls_total`` unconditionally), and
every wire byte flows through ``MeasuredTransport.send`` so the registry's
``trident_wire_bits_total`` equals ``per_link()`` exactly — a subclass
that overrides ``send`` or writes to sockets directly breaks the
double-booking.
"""
from __future__ import annotations

import ast

from .core import (Module, Rule, call_name, const_str, is_protocol_module,
                   iter_calls, register)

# The byte-accounting base: subclasses implement only these hooks.
_TRANSPORT_HOOK_WHITELIST = {
    "_put", "_get", "_round_flush", "close", "start", "connect",
    "__init__", "__repr__", "stop",
}
_TRANSPORT_SEAM_METHODS = {"send", "recv", "round", "per_link", "phase_bits",
                           "forbid_phase", "allow_phase"}

# Raw socket writes are confined to the framing layer.
_RAW_SOCKET_OWNERS = (
    "runtime/net/framing.py",
    "runtime/net/socket_transport.py",
)

# Calls that constitute "touching the transport" for coverage purposes.
_TRANSPORT_TOUCH_SUFFIXES = (".send", ".recv", ".round", ".prep.acquire")


def _is_traced(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if call_name(ast.Call(func=target, args=[], keywords=[])) \
                .endswith("traced_protocol"):
            return True
    return False


@register
class ObsUntracedProtocolEntry(Rule):
    id = "OBS001"
    name = "untraced-protocol-entry"
    doc = ("A public module-level protocol function (first arg `rt`) that "
           "touches the transport — directly or through underscore helpers "
           "not themselves shielded by a traced function — must carry "
           "@traced_protocol so calls/bytes land in the registry.")

    def applies(self, relpath: str) -> bool:
        return is_protocol_module(relpath)

    def check(self, module: Module) -> list:
        top_fns = {}
        for node in module.tree.body:
            if isinstance(node, ast.FunctionDef):
                top_fns[node.name] = node

        # Which top-level functions *directly* touch the transport?
        direct = set()
        calls_of = {name: set() for name in top_fns}
        for name, fn in top_fns.items():
            for call in iter_calls(fn):
                cn = call_name(call)
                if any(cn.endswith(s) for s in _TRANSPORT_TOUCH_SUFFIXES):
                    direct.add(name)
                head = cn.split(".")[0]
                if head in top_fns:
                    calls_of[name].add(head)

        # Transitive touch, stopping at traced functions (they already
        # account for everything beneath them).
        def touches(name: str, seen: frozenset) -> bool:
            if name in direct:
                return True
            for callee in calls_of[name]:
                if callee in seen:
                    continue
                if _is_traced(top_fns[callee]):
                    continue
                if touches(callee, seen | {callee}):
                    return True
            return False

        out = []
        for name, fn in top_fns.items():
            if name.startswith("_") or _is_traced(fn):
                continue
            args = fn.args.posonlyargs + fn.args.args
            if not args or args[0].arg != "rt":
                continue
            if touches(name, frozenset({name})):
                out.append(module.finding(
                    self.id, fn,
                    f"public protocol entry `{name}` touches the transport "
                    "without @traced_protocol"))
        return out


@register
class ObsTransportSeamOverride(Rule):
    id = "OBS002"
    name = "transport-seam-override"
    doc = ("MeasuredTransport subclasses may only implement the _put/_get/"
           "_round_flush hooks; overriding send/recv/round (or writing raw "
           "sockets outside the framing layer) bypasses byte accounting.")

    def check(self, module: Module) -> list:
        out = []
        for node in module.nodes:
            if isinstance(node, ast.ClassDef):
                bases = {call_name(ast.Call(func=b, args=[], keywords=[]))
                         .split(".")[-1] for b in node.bases}
                if "MeasuredTransport" not in bases:
                    continue
                for item in node.body:
                    if (isinstance(item, ast.FunctionDef)
                            and item.name in _TRANSPORT_SEAM_METHODS):
                        out.append(module.finding(
                            self.id, item,
                            f"{node.name} overrides MeasuredTransport."
                            f"{item.name}; implement _put/_get/_round_flush "
                            "instead"))
        if module.relpath not in _RAW_SOCKET_OWNERS:
            for call in module.calls:
                if call_name(call).endswith(".sendall"):
                    out.append(module.finding(
                        self.id, call,
                        "raw socket sendall outside the framing layer "
                        "bypasses MeasuredTransport byte accounting"))
        return out


@register
class ObsMetricTaxonomy(Rule):
    id = "OBS003"
    name = "metric-name-taxonomy"
    doc = ("Registry metrics declared with a literal name must use the "
           "`trident_` prefix so exporter scrapes and the bench-regression "
           "gate see one namespace.")

    _DECLS = (".counter", ".gauge", ".histogram")

    def check(self, module: Module) -> list:
        if module.relpath == "obs/registry.py":
            return []  # the registry itself (generic helpers/tests of API)
        out = []
        for call in module.calls:
            cn = call_name(call)
            if not any(cn.endswith(s) for s in self._DECLS):
                continue
            # only registry-ish receivers: reg.counter / registry.gauge /
            # get_registry().histogram — skip collections.Counter etc.
            recv = cn.rsplit(".", 1)[0]
            if not ("reg" in recv or "registry" in recv.lower()):
                continue
            name = const_str(call.args[0]) if call.args else None
            if name is not None and not name.startswith("trident_"):
                out.append(module.finding(
                    self.id, call,
                    f"metric name {name!r} missing `trident_` prefix"))
        return out
