"""Concurrency audit rules (CONC0xx).

Static model: for each class in a threaded module we extract

* its lock attributes (``self.x = threading.Lock()/RLock()/Condition()``),
  with ``Condition(self.y)`` recorded as an *alias* of ``y`` since both
  names acquire the same underlying lock;
* its thread entry points (``threading.Thread(target=self.m)``) and the
  intra-class call graph over ``self.m()`` calls;
* every ``with self.lock:`` acquisition and every ``self.attr`` access.

CONC001 builds the lock-acquisition digraph (nested ``with`` blocks plus
locks acquired by methods called while holding a lock) and reports cycles.
CONC002 flags instance attributes that cross the thread/caller boundary
without a guarding lock.  CONC003–CONC005 are pattern rules: swallowed
broad excepts, non-daemon unjoined threads, and blocking ``Queue.get()``
in thread loops.
"""
from __future__ import annotations

import ast

from .core import (Module, Rule, body_is_trivial, call_name, dotted_name,
                   is_threaded_module, iter_calls, kwarg, register, self_attr)

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore")


class _ClassModel:
    """Per-class facts for the lock-graph and shared-attr rules."""

    def __init__(self, mod: Module, cls: ast.ClassDef):
        self.mod = mod
        self.cls = cls
        self.methods = {n.name: n for n in cls.body
                        if isinstance(n, ast.FunctionDef)}
        self.lock_attrs = {}      # attr -> canonical attr (alias resolution)
        self.thread_targets = set()
        self.calls = {}           # method -> set of self-methods called
        self._scan()

    def _scan(self) -> None:
        for m in self.methods.values():
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    attr = self_attr(node.targets[0])
                    if attr and isinstance(node.value, ast.Call):
                        ctor = call_name(node.value).split(".")[-1]
                        if ctor in _LOCK_CTORS:
                            canon = attr
                            if ctor == "Condition" and node.value.args:
                                inner = self_attr(node.value.args[0])
                                if inner:
                                    canon = inner
                            self.lock_attrs[attr] = canon
        # resolve alias chains (Condition(self.a) where a itself aliases)
        for attr in list(self.lock_attrs):
            seen = {attr}
            cur = self.lock_attrs[attr]
            while cur in self.lock_attrs and self.lock_attrs[cur] != cur \
                    and cur not in seen:
                seen.add(cur)
                cur = self.lock_attrs[cur]
            self.lock_attrs[attr] = cur

        for name, m in self.methods.items():
            called = set()
            for call in iter_calls(m):
                cn = call_name(call)
                if cn.startswith("self.") and cn.count(".") == 1:
                    callee = cn.split(".")[1]
                    if callee in self.methods:
                        called.add(callee)
                if cn.split(".")[-1] == "Thread":
                    tgt = kwarg(call, "target")
                    t_attr = self_attr(tgt) if tgt is not None else None
                    if t_attr and t_attr in self.methods:
                        self.thread_targets.add(t_attr)
            self.calls[name] = called

    def canon(self, attr: str) -> str:
        return self.lock_attrs.get(attr, attr)

    def acquired_locks(self, withitem: ast.withitem):
        """Canonical lock attr acquired by a with-item, or None."""
        ctx = withitem.context_expr
        attr = self_attr(ctx)
        if attr and attr in self.lock_attrs:
            return self.canon(attr)
        return None

    def locks_in_method(self, name: str, seen=None) -> set:
        """All canonical locks acquired by a method, transitively."""
        seen = seen or set()
        if name in seen or name not in self.methods:
            return set()
        seen.add(name)
        out = set()
        for node in ast.walk(self.methods[name]):
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = self.acquired_locks(item)
                    if lk:
                        out.add(lk)
        for callee in self.calls.get(name, ()):
            out |= self.locks_in_method(callee, seen)
        return out

    def reachable_from(self, roots: set) -> set:
        out, stack = set(), list(roots)
        while stack:
            cur = stack.pop()
            if cur in out:
                continue
            out.add(cur)
            stack.extend(self.calls.get(cur, ()))
        return out


def _class_models(mod: Module):
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef):
            yield _ClassModel(mod, node)


@register
class ConcLockOrderCycle(Rule):
    id = "CONC001"
    name = "lock-order-cycle"
    doc = ("Two locks of one class acquired in opposite nesting orders "
           "(directly, or via a method called while holding a lock) can "
           "deadlock two threads; the acquisition digraph must be acyclic.")

    def applies(self, relpath: str) -> bool:
        return is_threaded_module(relpath)

    def check(self, module: Module) -> list:
        out = []
        for cm in _class_models(module):
            edges = {}  # lock -> set of locks acquired while held

            def add_edge(a: str, b: str) -> None:
                if a != b:
                    edges.setdefault(a, set()).add(b)

            for _name, meth in cm.methods.items():
                for node in ast.walk(meth):
                    if not isinstance(node, ast.With):
                        continue
                    held = [lk for it in node.items
                            if (lk := cm.acquired_locks(it))]
                    if not held:
                        continue
                    for inner in ast.walk(node):
                        if inner is node:
                            continue
                        if isinstance(inner, ast.With):
                            for it in inner.items:
                                lk = cm.acquired_locks(it)
                                if lk:
                                    for h in held:
                                        add_edge(h, lk)
                        if isinstance(inner, ast.Call):
                            cn = call_name(inner)
                            if cn.startswith("self.") and cn.count(".") == 1:
                                callee = cn.split(".")[1]
                                for lk in cm.locks_in_method(callee):
                                    for h in held:
                                        add_edge(h, lk)

            # cycle detection (DFS, report one finding per cycle edge set)
            WHITE, GREY, BLACK = 0, 1, 2
            color = {n: WHITE for n in
                     set(edges) | {b for bs in edges.values() for b in bs}}
            stack: list = []
            cycles = []

            def dfs(n: str) -> None:
                color[n] = GREY
                stack.append(n)
                for m in edges.get(n, ()):
                    if color[m] == GREY:
                        cycles.append(stack[stack.index(m):] + [m])
                    elif color[m] == WHITE:
                        dfs(m)
                stack.pop()
                color[n] = BLACK

            for n in list(color):
                if color[n] == WHITE:
                    dfs(n)
            for cyc in cycles:
                out.append(module.finding(
                    self.id, cm.cls,
                    f"lock-order cycle on {cm.cls.name}: "
                    + " -> ".join(cyc),
                    anchor=f"{cm.cls.name}.{'/'.join(sorted(set(cyc)))}"))
        return out


# Attributes assigned only boolean/None constants act as GIL-safe stop
# flags; flagging them would bury the signal.
def _is_flag_write(node) -> bool:
    val = node.value if isinstance(node, ast.Assign) else None
    return (isinstance(val, ast.Constant)
            and (val.value is None or isinstance(val.value, bool)))


@register
class ConcUnguardedSharedWrite(Rule):
    id = "CONC002"
    name = "unguarded-shared-attr"
    doc = ("An instance attribute touched from both a thread entry point "
           "and caller-side methods needs a guarding lock (or a queue "
           "hand-off); bool/None stop-flags are exempt.")

    def applies(self, relpath: str) -> bool:
        return is_threaded_module(relpath)

    def check(self, module: Module) -> list:
        out = []
        for cm in _class_models(module):
            if not cm.thread_targets:
                continue
            thread_side = cm.reachable_from(cm.thread_targets)
            # attr -> {"t_w","t_r","d_w","d_r"} with unguarded-ness
            acc = {}
            flagish = set()

            for name, meth in cm.methods.items():
                side = "t" if name in thread_side else "d"
                if name == "__init__":
                    continue  # runs before any thread starts
                for node in ast.walk(meth):
                    guarded = any(
                        isinstance(a, ast.With)
                        and any(cm.acquired_locks(it) for it in a.items)
                        for a in module.ancestors(node))
                    if isinstance(node, (ast.Assign, ast.AugAssign)):
                        targets = (node.targets if isinstance(node, ast.Assign)
                                   else [node.target])
                        for t in targets:
                            attr = self_attr(t)
                            if not attr or attr in cm.lock_attrs:
                                continue
                            if _is_flag_write(node):
                                flagish.add(attr)
                                continue
                            if not guarded:
                                acc.setdefault(attr, set()).add(side + "_w")
                    elif isinstance(node, ast.Attribute) and \
                            isinstance(node.ctx, ast.Load):
                        attr = self_attr(node)
                        if attr and attr not in cm.lock_attrs and not guarded:
                            acc.setdefault(attr, set()).add(side + "_r")

            for attr, kinds in sorted(acc.items()):
                wrote_thread = "t_w" in kinds
                wrote_caller = "d_w" in kinds
                crosses = (wrote_thread and ("d_r" in kinds or wrote_caller)) \
                    or (wrote_caller and "t_r" in kinds)
                if crosses and attr not in flagish:
                    out.append(module.finding(
                        self.id, cm.cls,
                        f"{cm.cls.name}.{attr} crosses the thread/caller "
                        "boundary without a guarding lock",
                        anchor=f"{cm.cls.name}.{attr}"))
        return out


@register
class ConcBroadExcept(Rule):
    id = "CONC003"
    name = "swallowed-broad-except"
    doc = ("bare `except:` anywhere, and `except Exception: pass` "
           "(a handler that swallows everything), hide thread deaths and "
           "protocol desyncs; narrow to the expected exception types.")

    _BROAD = ("Exception", "BaseException")

    def check(self, module: Module) -> list:
        out = []
        for node in module.nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                out.append(module.finding(
                    self.id, node, "bare `except:` (catches KeyboardInterrupt "
                    "and SystemExit); name the expected exceptions"))
                continue
            names = []
            types = (node.type.elts if isinstance(node.type, ast.Tuple)
                     else [node.type])
            for t in types:
                names.append(dotted_name(t).split(".")[-1])
            if any(n in self._BROAD for n in names) \
                    and body_is_trivial(node.body):
                out.append(module.finding(
                    self.id, node,
                    "`except Exception: pass` swallows every failure "
                    "silently; narrow the type or handle the error"))
        return out


@register
class ConcNonDaemonThread(Rule):
    id = "CONC004"
    name = "non-daemon-unjoined-thread"
    doc = ("A Thread without daemon=True that nothing joins keeps the "
           "process alive after the main thread exits.")

    def check(self, module: Module) -> list:
        has_join = any(call_name(c).endswith(".join")
                       for c in module.calls)
        out = []
        for call in module.calls:
            if call_name(call).split(".")[-1] != "Thread":
                continue
            if kwarg(call, "target") is None and not call.args:
                continue  # Thread subclass-style or unrelated
            d = kwarg(call, "daemon")
            daemon = (isinstance(d, ast.Constant) and d.value is True)
            if not daemon and not has_join:
                out.append(module.finding(
                    self.id, call,
                    "non-daemon Thread never joined in this module"))
        return out


@register
class ConcBlockingGet(Rule):
    id = "CONC005"
    name = "blocking-get-in-thread-loop"
    doc = ("A no-timeout Queue.get() inside a thread's while-loop can "
           "block forever if the producer dies; use get(timeout=...) and "
           "re-check liveness.")

    def applies(self, relpath: str) -> bool:
        return is_threaded_module(relpath)

    def check(self, module: Module) -> list:
        # thread entry points: self-methods via class models + module-level
        # functions passed to Thread(target=...)
        entries = set()
        for cm in _class_models(module):
            for t in cm.thread_targets:
                entries.add(cm.methods[t])
        for call in module.calls:
            if call_name(call).split(".")[-1] == "Thread":
                tgt = kwarg(call, "target")
                if isinstance(tgt, ast.Name):
                    for node in module.tree.body:
                        if isinstance(node, ast.FunctionDef) \
                                and node.name == tgt.id:
                            entries.add(node)

        out = []
        for fn in entries:
            for node in ast.walk(fn):
                if not isinstance(node, ast.While):
                    continue
                for call in iter_calls(node):
                    cn = call_name(call)
                    if not cn.endswith(".get"):
                        continue
                    if call.args or call.keywords:
                        continue  # dict.get(k) / get(timeout=...)
                    out.append(module.finding(
                        self.id, call,
                        f"blocking `{cn}()` in thread loop "
                        f"`{fn.name}`; add timeout= and re-check liveness"))
        return out
