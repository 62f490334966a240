"""tridentlint core: module loading, AST utilities, rule registry, engine.

The port's copy of ``repro/analysis/core.py``.  The analyzer is
deliberately self-contained (stdlib ``ast`` only, no ``torch``) so it can
run in CI before any heavyweight dependency import.  Every rule is a
subclass of :class:`Rule` registered via :func:`register`; the engine walks
a file tree, parses each module once, attaches parent links, and hands each
in-scope module to each rule.

Findings are matched against the committed baseline on the stable key
``(rule, file, anchor)`` — *not* line numbers — so unrelated edits to a
file do not churn the baseline.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional


# --------------------------------------------------------------------------
# findings


@dataclass(frozen=True)
class Finding:
    """One analyzer hit.

    ``anchor`` is the qualified name of the enclosing scope (or another
    stable identifier such as ``Class.attr``) used for baseline matching;
    ``line`` is attribution only and never participates in matching.
    """

    rule: str
    file: str          # path relative to the scan root (posix)
    line: int
    anchor: str
    message: str

    @property
    def key(self) -> tuple:
        return (self.rule, self.file, self.anchor)

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} [{self.anchor}] {self.message}"


# --------------------------------------------------------------------------
# parsed modules


@dataclass
class Module:
    """A parsed source module with parent-linked AST.

    ``nodes`` holds every node in ``ast.walk`` order and ``calls`` its
    Call nodes, walked once at load: the rules read them instead of
    walking the whole tree each."""

    path: Path
    relpath: str                  # posix, relative to scan root (or pretend)
    tree: ast.Module
    source: str = ""
    _parents: dict = field(default_factory=dict, repr=False)
    nodes: list = field(default_factory=list, repr=False)
    calls: list = field(default_factory=list, repr=False)

    @classmethod
    def load(cls, path: Path, relpath: str) -> "Module":
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
        mod = cls(path=path, relpath=relpath, tree=tree, source=src)
        mod._link_parents()
        return mod

    def _link_parents(self) -> None:
        for node in ast.walk(self.tree):
            self.nodes.append(node)
            if isinstance(node, ast.Call):
                self.calls.append(node)
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node

    # -- navigation --------------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def qualname(self, node: ast.AST) -> str:
        """Dotted path of enclosing defs/classes, innermost last.

        For a node with no enclosing scope, returns ``<module>``.
        """
        parts = []
        scopes = [node] if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) else []
        scopes.extend(a for a in self.ancestors(node)
                      if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                        ast.ClassDef)))
        for s in reversed(scopes):
            parts.append(s.name)
        return ".".join(parts) if parts else "<module>"

    def finding(self, rule: str, node: ast.AST, message: str,
                anchor: Optional[str] = None) -> Finding:
        return Finding(rule=rule, file=self.relpath,
                       line=getattr(node, "lineno", 0),
                       anchor=anchor if anchor is not None else self.qualname(node),
                       message=message)


# --------------------------------------------------------------------------
# AST helpers shared by rule modules


def dotted_name(node: ast.AST) -> str:
    """Render a Name/Attribute chain as ``a.b.c`` ('' when not a chain)."""
    parts = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Call):
        # e.g. get_registry().counter — render the call target then '()'
        inner = dotted_name(cur.func)
        parts.append(inner + "()" if inner else "()")
    else:
        return ""
    return ".".join(reversed(parts))


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def iter_calls(root: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(root):
        if isinstance(node, ast.Call):
            yield node


def kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """Return ``attr`` when node is exactly ``self.attr``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def body_is_trivial(body: list) -> bool:
    """True when an except body only passes/continues (swallows)."""
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)):
            continue  # docstring / ellipsis
        return False
    return True


# --------------------------------------------------------------------------
# rule registry


class Rule:
    """Base class: subclasses set ``id``, ``name``, ``doc`` and implement
    :meth:`check`.  ``applies`` scopes a rule to a relpath family; fixture
    runs bypass it via ``force``."""

    id: str = ""
    name: str = ""
    doc: str = ""

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, module: Module) -> list:
        raise NotImplementedError


_REGISTRY: dict = {}


def register(cls: type) -> type:
    inst = cls()
    if inst.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {inst.id}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> dict:
    # import for side-effect registration; local to dodge import cycles
    from . import rules_prep, rules_phase, rules_obs, rules_concurrency  # noqa: F401
    return dict(_REGISTRY)


# --------------------------------------------------------------------------
# engine


# Protocol bodies live under runtime/ -- every module there is in scope
# for the prep/phase/obs seam rules EXCEPT the infrastructure that
# implements the seams themselves (runtime.py owns the PRF tree and
# sample_group, party.py folds keys, kernel_backend.py calls the PRF
# kernel's wrapper, transport.py implements the phase machinery) and the
# net/ mesh layer.
_RUNTIME_INFRA = (
    "runtime/__init__.py",
    "runtime/runtime.py",
    "runtime/party.py",
    "runtime/kernel_backend.py",
    "runtime/transport.py",
)

# Modules with in-process threads, in scope for the concurrency audit:
# the JAX package's list (each path names the port's counterpart; the
# port's obs/health.py scrapes without a thread of its own and is kept so
# the two lists agree on the JAX tree), then the port's modules that take
# a lock or a thread-local its JAX counterpart lacks or never audited:
# the tracer (appends from a daemon's control and task threads, CUDA
# timing events pending), the kernel loader (_LOAD_LOCK) and the PRF
# wrapper's per-thread tables.  The class model sees only ``self.x``
# locks: a module-level lock or thread-local is a known blind spot.
THREADED_MODULES = (
    "runtime/net/cluster.py",
    "runtime/net/socket_transport.py",
    "serve/gateway.py",
    "offline/live.py",
    "offline/continuous.py",
    "offline/pipeline.py",
    "obs/registry.py",
    "obs/exporter.py",
    "obs/health.py",
    "obs/tracer.py",
    "kernels/build.py",
    "kernels/prf_mask.py",
)


def is_protocol_module(relpath: str) -> bool:
    return (relpath.startswith("runtime/")
            and not relpath.startswith("runtime/net/")
            and relpath not in _RUNTIME_INFRA)


def is_threaded_module(relpath: str) -> bool:
    return relpath in THREADED_MODULES


def load_tree(root: Path) -> list:
    """Parse every .py under root (skipping caches) into Modules."""
    mods = []
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(root).as_posix()
        mods.append(Module.load(path, rel))
    return mods


def run_rules(modules: Iterable[Module], rules: Optional[Iterable[str]] = None,
              force: bool = False) -> list:
    """Run (selected) rules over modules; force bypasses path scoping,
    used by fixture tests and the injected-violation CI check."""
    registry = all_rules()
    selected = [registry[r] for r in rules] if rules else list(registry.values())
    findings = []
    for mod in modules:
        for rule in selected:
            if force or rule.applies(mod.relpath):
                findings.extend(rule.check(mod))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return findings
