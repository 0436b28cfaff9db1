"""Shared-state lint: unlocked global writes, guarded fields, raw threads.

Three checks over the same parsed modules as the lock-order pass:

1. **unlocked-global-write** — a module-level mutable container
   (``LAST_RUN_INFO``-style dict, ``MESH_WARMUP_ENTRIES``-style list,
   ``WARM_CLASSES``-style set) mutated inside a function without a lock
   lexically held.  Exempt: module import time, functions named
   ``reset_*`` / ``_reset*`` (the single-threaded test-reset init path),
   and sites carrying a trailing ``# unlocked-ok: <reason>`` comment.

2. **guarded-field** — the ``# guarded_by: <lock>`` convention.  A
   trailing comment on a field initialisation
   (``self._entries = ...  # guarded_by: _lock`` in ``__init__``, or a
   module global) declares its guard; every later read or write of that
   field must happen with the guard lexically held, in a method whose
   name ends in ``_locked`` (the held-by-caller convention this codebase
   already uses), in ``__init__``/``__new__``, or under a trailing
   ``# unguarded-ok: <reason>``.

3. **unregistered-thread** — a direct ``threading.Thread(...)`` call
   anywhere in the package.  Background threads must go through
   ``analysis.threadreg.spawn`` so they carry a name and an owner; the
   registry's own spawn site is marked ``# thread-ok``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from trino_tpu_torch.analysis.lockgraph import (
    Finding, LockGraphResult, _ClassInfo, _FuncInfo, _ModuleInfo, _Resolver,
    _line_has,
)

__all__ = ["scan_shared_state"]

_MUTABLE_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict", "deque", "Counter"}
_MUTATORS = {
    "update", "clear", "append", "extend", "add", "remove", "discard",
    "pop", "popitem", "setdefault", "insert", "appendleft", "popleft",
}
_GUARD_RE = re.compile(r"#\s*guarded_by:\s*([A-Za-z_][\w.]*)")


def _mutable_globals(mod: _ModuleInfo) -> Dict[str, int]:
    """NAME -> def line for module-level mutable container globals."""
    out: Dict[str, int] = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue
            value = node.value
            if value is None:
                continue
            name = targets[0].id
            if isinstance(value, (ast.Dict, ast.List, ast.Set)):
                out[name] = node.lineno
            elif isinstance(value, ast.Call):
                f = value.func
                ctor = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else None)
                if ctor in _MUTABLE_CTORS:
                    out[name] = node.lineno
    return out


def _module_guards(mod: _ModuleInfo) -> Dict[str, str]:
    """NAME -> lock_id for `# guarded_by:` annotated module globals."""
    guards: Dict[str, str] = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue
            m = _guard_on_line(mod, node.lineno)
            if m is None:
                continue
            lock_id = _resolve_guard_name(mod, None, m)
            if lock_id is not None:
                guards[targets[0].id] = lock_id
    return guards


def _class_guards(mod: _ModuleInfo, ci: _ClassInfo) -> Dict[str, str]:
    """attr -> lock_id for `# guarded_by:` annotated self.X inits."""
    guards: Dict[str, str] = {}
    for fi in ci.methods.values():
        for node in ast.walk(fi.node):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if len(targets) != 1:
                continue
            t = targets[0]
            if not (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            m = _guard_on_line(mod, node.lineno)
            if m is None:
                continue
            lock_id = _resolve_guard_name(mod, ci, m)
            if lock_id is not None:
                guards[t.attr] = lock_id
    # class-body declarations: `x: int = 0  # guarded_by: _lock`
    for mnode in mod.tree.body:
        if isinstance(mnode, ast.ClassDef) and mnode.name == ci.name:
            for node in mnode.body:
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    if len(targets) == 1 and isinstance(targets[0], ast.Name):
                        m = _guard_on_line(mod, node.lineno)
                        if m is not None:
                            lock_id = _resolve_guard_name(mod, ci, m)
                            if lock_id is not None:
                                guards[targets[0].id] = lock_id
    return guards


def _guard_on_line(mod: _ModuleInfo, line: int) -> Optional[str]:
    if 1 <= line <= len(mod.lines):
        m = _GUARD_RE.search(mod.lines[line - 1])
        if m:
            return m.group(1)
    return None


def _resolve_guard_name(mod: _ModuleInfo, ci: Optional[_ClassInfo],
                        name: str) -> Optional[str]:
    """`_lock` -> the lock id of the class attr / module global."""
    if ci is not None and name in ci.lock_attrs:
        return ci.lock_attrs[name].lock_id
    if name in mod.locks:
        return mod.locks[name].lock_id
    if "." in name:
        return name  # already a fully-qualified lock id
    return None


def _assigned_locals(fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(names assigned in fn, names declared global/nonlocal)."""
    assigned: Set[str] = set()
    globals_: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            assigned.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            globals_.update(node.names)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            assigned.add(node.id)
        elif isinstance(node, (ast.For, ast.comprehension)):
            tgt = node.target
            for n in ast.walk(tgt):
                if isinstance(n, ast.Name):
                    assigned.add(n.id)
    return assigned, globals_


class _StateWalker:
    """Held-lock-aware walk of one function for state checks."""

    def __init__(self, res: _Resolver, mod: _ModuleInfo, ci: Optional[_ClassInfo],
                 fi: _FuncInfo, ctx: "_StateContext", findings: List[Finding]):
        self.res = res
        self.mod = mod
        self.ci = ci
        self.fi = fi
        self.ctx = ctx
        self.findings = findings
        self.fname = fi.node.name if hasattr(fi.node, "name") else "<lambda>"
        self.assigned, self.globals_ = _assigned_locals(fi.node)
        self.is_init = self.fname in ("__init__", "__new__", "__post_init__")
        self.is_locked_conv = self.fname.endswith("_locked")
        self.is_reset = self.fname.startswith("reset_") or self.fname.startswith("_reset")

    # -- helpers --
    def _global_ref(self, expr: ast.AST) -> Optional[Tuple[_ModuleInfo, str]]:
        """Resolve expr to (module, NAME) for a module-level global."""
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in self.assigned and name not in self.globals_:
                return None  # shadowed by a local
            return (self.mod, name)
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)):
            alias = self.mod.import_mods.get(expr.value.id)
            if alias is not None:
                src = self.res.modules.get(alias)
                if src is not None:
                    return (src, expr.attr)
        return None

    def _suppressed(self, line: int, marker: str) -> bool:
        return _line_has(self.mod, line, marker)

    def _check_mutation(self, expr: ast.AST, held: Tuple[str, ...], line: int) -> None:
        ref = self._global_ref(expr)
        if ref is None:
            return
        src, name = ref
        if name not in self.ctx.mutable_globals.get(src.dotted, ()):
            return
        guard = self.ctx.module_guards.get(src.dotted, {}).get(name)
        if guard is not None and guard in held:
            return
        if guard is None and held:
            return  # generic lint: any lock held counts
        if self.is_reset or self._suppressed(line, "unlocked-ok"):
            return
        self.findings.append(Finding(
            "unlocked-global-write", self.mod.file, line,
            "mutable module global %s.%s written in %s without holding %s"
            % (src.stem, name, self.fi.qualname,
               repr(guard) if guard else "a lock")))

    def _check_guarded_access(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        # self.X loads/stores against class guards
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "self" and self.ci is not None):
            guard = self.ctx.class_guards.get(
                (self.mod.dotted, self.ci.name), {}).get(node.attr)
            if guard is None or guard in held:
                return
            if self.is_init or self.is_locked_conv:
                return
            if self._suppressed(node.lineno, "unguarded-ok"):
                return
            self.findings.append(Finding(
                "guarded-field", self.mod.file, node.lineno,
                "%s accesses self.%s without holding its declared guard %r"
                % (self.fi.qualname, node.attr, guard)))
            return
        # module-global guarded reads/writes (same module or via alias)
        ref = self._global_ref(node) if isinstance(node, (ast.Name, ast.Attribute)) else None
        if ref is None:
            return
        src, name = ref
        guard = self.ctx.module_guards.get(src.dotted, {}).get(name)
        if guard is None or guard in held:
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            return  # plain rebind is atomic; the mutation lint covers the rest
        if self.is_init or self.is_locked_conv or self.is_reset:
            return
        if self._suppressed(node.lineno, "unguarded-ok"):
            return
        self.findings.append(Finding(
            "guarded-field", self.mod.file, node.lineno,
            "%s accesses %s.%s without holding its declared guard %r"
            % (self.fi.qualname, src.stem, name, guard)))

    # -- traversal --
    def run(self) -> None:
        node = self.fi.node
        self._walk(getattr(node, "body", []), ())

    def _walk(self, stmts, held: Tuple[str, ...]) -> None:
        for st in stmts:
            self._walk_stmt(st, held)

    def _walk_stmt(self, st: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(st, ast.With):
            new_held = held
            for item in st.items:
                self._check_expr(item.context_expr, held)
                ld = self.res.resolve_lock(self.mod, self.fi.cls, item.context_expr)
                if ld is not None:
                    new_held = new_held + (ld.lock_id,)
            self._walk(st.body, new_held)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            nested = _FuncInfo("%s.<locals>.%s" % (self.fi.qualname, st.name),
                               self.fi.file, st, self.fi.cls, self.fi.module)
            _StateWalker(self.res, self.mod, self.ci, nested, self.ctx,
                         self.findings).run()
            return
        if isinstance(st, ast.Assign):
            for t in st.targets:
                self._check_target(t, held)
            self._check_expr(st.value, held)
            return
        if isinstance(st, ast.AugAssign):
            self._check_target(st.target, held, aug=True)
            self._check_expr(st.value, held)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._check_target(st.target, held)
                self._check_expr(st.value, held)
            return
        if isinstance(st, ast.Delete):
            for t in st.targets:
                self._check_target(t, held)
            return
        for _f, value in ast.iter_fields(st):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._walk_stmt(v, held)
                    elif isinstance(v, ast.excepthandler):
                        if v.type is not None:
                            self._check_expr(v.type, held)
                        self._walk(v.body, held)
                    elif isinstance(v, ast.AST):
                        self._check_expr(v, held)
            elif isinstance(value, ast.AST):
                self._check_expr(value, held)

    def _check_target(self, t: ast.AST, held: Tuple[str, ...], aug: bool = False) -> None:
        if isinstance(t, ast.Subscript):
            self._check_mutation(t.value, held, t.lineno)
            self._check_guarded_access(t.value, held)
            self._check_expr(t.slice, held)
        elif isinstance(t, ast.Name):
            if aug:
                self._check_mutation(t, held, t.lineno)
            self._check_guarded_access(t, held)
        elif isinstance(t, ast.Attribute):
            self._check_guarded_access(t, held)
            if aug:
                self._check_mutation(t, held, t.lineno)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._check_target(el, held)

    def _check_expr(self, expr: ast.AST, held: Tuple[str, ...]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
                    self._check_mutation(f.value, held, node.lineno)
            elif isinstance(node, (ast.Name, ast.Attribute)):
                self._check_guarded_access(node, held)


class _StateContext:
    def __init__(self, result: LockGraphResult):
        self.mutable_globals: Dict[str, Dict[str, int]] = {}
        self.module_guards: Dict[str, Dict[str, str]] = {}
        self.class_guards: Dict[Tuple[str, str], Dict[str, str]] = {}
        for dotted, mod in result.modules.items():
            self.mutable_globals[dotted] = _mutable_globals(mod)
            self.module_guards[dotted] = _module_guards(mod)
            for ci in mod.classes.values():
                g = _class_guards(mod, ci)
                if g:
                    self.class_guards[(dotted, ci.name)] = g


def _scan_threads(mod: _ModuleInfo, findings: List[Finding]) -> None:
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        is_thread = (
            (isinstance(f, ast.Attribute) and f.attr == "Thread"
             and isinstance(f.value, ast.Name)
             and f.value.id in ("threading", "_threading"))
            or (isinstance(f, ast.Name) and f.id == "Thread"
                and mod.import_names.get("Thread", ("", ""))[0] == "threading")
        )
        if is_thread and not _line_has(mod, node.lineno, "thread-ok"):
            findings.append(Finding(
                "unregistered-thread", mod.file, node.lineno,
                "direct threading.Thread(...) spawn bypasses "
                "analysis.threadreg — use threadreg.spawn(name, target, "
                "owner=...) so the thread is named and leak-checked"))


def scan_shared_state(result: LockGraphResult) -> List[Finding]:
    """Run the shared-state checks over an already-parsed lock graph."""
    findings: List[Finding] = []
    ctx = _StateContext(result)
    res = result.resolver
    for dotted, mod in sorted(result.modules.items()):
        _scan_threads(mod, findings)
        funcs: List[Tuple[Optional[_ClassInfo], _FuncInfo]] = [
            (None, fi) for fi in mod.functions.values()]
        for ci in mod.classes.values():
            funcs.extend((ci, fi) for fi in ci.methods.values())
        for ci, fi in funcs:
            _StateWalker(res, mod, ci, fi, ctx, findings).run()
    return findings
