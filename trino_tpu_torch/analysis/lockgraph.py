"""Static lock-order analysis over the package source.

An AST pass that

1. finds every lock *definition* — ``threading.Lock()`` / ``RLock()`` /
   ``Condition()`` assignments plus the witness factories
   ``named_lock("...")`` / ``named_rlock`` / ``named_condition`` — and
   gives each a stable id (the witness name literal when present, else
   ``Class.attr`` / ``module.attr``);
2. extracts every acquisition site: ``with self._lock:``, raw
   ``.acquire()`` calls, and ``Condition.wait`` re-acquisitions,
   attributed to a lock definition through a light resolver (self
   attributes, module globals, imported module attributes, module-level
   singletons of known classes, ``self.attr`` instance types);
3. builds the may-hold-while-acquiring graph across call edges (a
   fixpoint of locks-a-function-may-acquire propagated through resolved
   calls), and
4. reports every cycle as a potential deadlock, printing for each edge
   in the cycle the witness path file:line chain.

The resolver is deliberately conservative: an unresolved receiver
produces no lock event and no call edge, so the graph under-approximates
rather than hallucinating edges.  Findings it does produce name a
concrete construct at a concrete file:line.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "LockDef", "LockGraphResult", "scan_sources", "PACKAGE_ROOT"]

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOCK_CTORS = {"Lock", "RLock"}
_WITNESS_FACTORIES = {"named_lock": False, "named_rlock": True, "named_condition": True}


@dataclass
class Finding:
    kind: str
    file: str
    line: int
    message: str

    def __str__(self) -> str:
        return "[%s] %s:%d %s" % (self.kind, self.file, self.line, self.message)


@dataclass
class LockDef:
    lock_id: str
    file: str
    line: int
    reentrant: bool = False


@dataclass
class _FuncInfo:
    qualname: str          # "mod::Class.method" or "mod::func"
    file: str
    node: ast.AST
    cls: Optional[str]     # owning class name, if any
    module: str            # dotted module key


@dataclass
class _ClassInfo:
    name: str
    module: str
    bases: List[str] = field(default_factory=list)
    methods: Dict[str, _FuncInfo] = field(default_factory=dict)
    lock_attrs: Dict[str, LockDef] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)  # attr -> "mod::Class"


@dataclass
class _ModuleInfo:
    dotted: str            # e.g. "trino_tpu_torch.runtime.scheduler"
    stem: str              # "scheduler"
    file: str              # display path
    tree: ast.Module = None
    lines: List[str] = field(default_factory=list)
    classes: Dict[str, _ClassInfo] = field(default_factory=dict)
    functions: Dict[str, _FuncInfo] = field(default_factory=dict)
    locks: Dict[str, LockDef] = field(default_factory=dict)       # global name -> def
    singletons: Dict[str, str] = field(default_factory=dict)      # name -> "mod::Class"
    import_mods: Dict[str, str] = field(default_factory=dict)     # alias -> dotted
    import_names: Dict[str, Tuple[str, str]] = field(default_factory=dict)  # alias -> (dotted, name)


@dataclass
class _Event:
    kind: str                      # "acquire" | "call" | "wait"
    target: str                    # lock_id or callee qualname
    held: Tuple[str, ...]          # lock ids lexically held
    file: str
    line: int
    func: str


@dataclass
class LockGraphResult:
    locks: Dict[str, LockDef] = field(default_factory=dict)
    sites: int = 0
    edges: Dict[Tuple[str, str], List[str]] = field(default_factory=dict)
    cycles: List[List[str]] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)
    modules: Dict[str, "_ModuleInfo"] = field(default_factory=dict)
    events: Dict[str, List[_Event]] = field(default_factory=dict)
    resolver: Optional["_Resolver"] = None

    def order_pairs(self) -> List[Tuple[str, str]]:
        return sorted(self.edges.keys())


def _line_has(mod: _ModuleInfo, line: int, marker: str) -> bool:
    if 1 <= line <= len(mod.lines):
        return marker in mod.lines[line - 1]
    return False


def _call_name(node: ast.AST) -> Optional[str]:
    """'Lock' for threading.Lock() / Lock(); 'named_lock' for witness.named_lock()."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _literal_str_arg(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _lockdef_from_value(value: ast.AST, default_id: str, file: str) -> Optional[LockDef]:
    """A LockDef if `value` constructs a lock/condition, else None."""
    name = _call_name(value)
    if name is None:
        return None
    if name in _LOCK_CTORS:
        return LockDef(default_id, file, value.lineno, reentrant=(name == "RLock"))
    if name in _WITNESS_FACTORIES:
        lit = _literal_str_arg(value)
        return LockDef(lit or default_id, file, value.lineno,
                       reentrant=_WITNESS_FACTORIES[name])
    if name == "Condition":
        # bare Condition() owns a private RLock; Condition(x) aliases x
        # and is handled by the caller (needs the resolver).
        if not value.args:
            return LockDef(default_id, file, value.lineno, reentrant=True)
    return None


# -- phase A: per-module symbol collection --------------------------------

def _collect_module(dotted: str, file: str, source: str) -> Optional[_ModuleInfo]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    mod = _ModuleInfo(dotted=dotted, stem=dotted.rsplit(".", 1)[-1], file=file,
                      tree=tree, lines=source.splitlines())

    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.import_mods[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom):
            src = _resolve_from_import(dotted, node)
            if src is not None:
                for a in node.names:
                    if a.name == "*":
                        continue
                    mod.import_names[a.asname or a.name] = (src, a.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            value = node.value
            if value is None or len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue
            name = targets[0].id
            ld = _lockdef_from_value(value, "%s.%s" % (mod.stem, name), file)
            if ld is not None:
                mod.locks[name] = ld
            elif isinstance(value, ast.Call):
                ctor = _call_name(value)
                if ctor and ctor[:1].isupper():
                    mod.singletons[name] = ctor  # resolved to a class later
        elif isinstance(node, ast.ClassDef):
            ci = _ClassInfo(name=node.name, module=dotted,
                            bases=[b.id for b in node.bases if isinstance(b, ast.Name)])
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fi = _FuncInfo("%s::%s.%s" % (dotted, node.name, item.name),
                                   file, item, node.name, dotted)
                    ci.methods[item.name] = fi
            _collect_self_attrs(ci, file)
            mod.classes[node.name] = ci
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = _FuncInfo("%s::%s" % (dotted, node.name),
                                                 file, node, None, dotted)
    return mod


def _resolve_from_import(dotted: str, node: ast.ImportFrom) -> Optional[str]:
    if node.level == 0:
        return node.module
    parts = dotted.split(".")
    if node.level > len(parts):
        return None
    base = parts[: len(parts) - node.level]
    if node.module:
        base.append(node.module)
    return ".".join(base)


def _collect_self_attrs(ci: _ClassInfo, file: str) -> None:
    """Scan all methods for self.X = Lock()/ClassName()/Condition(self.Y)."""
    for fi in ci.methods.values():
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            t = node.targets[0]
            if not (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            attr = t.attr
            default_id = "%s.%s" % (ci.name, attr)
            ld = _lockdef_from_value(node.value, default_id, file)
            if ld is not None:
                ci.lock_attrs.setdefault(attr, ld)
                continue
            if isinstance(node.value, ast.Call):
                cname = _call_name(node.value)
                if cname == "Condition" and node.value.args:
                    arg = node.value.args[0]
                    if (isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name)
                            and arg.value.id == "self" and arg.attr in ci.lock_attrs):
                        ci.lock_attrs.setdefault(attr, ci.lock_attrs[arg.attr])
                elif cname == "named_condition":
                    lit = _literal_str_arg(node.value)
                    ci.lock_attrs.setdefault(attr, LockDef(
                        lit or default_id, file, node.value.lineno, reentrant=True))
                elif cname and cname[:1].isupper():
                    ci.attr_types.setdefault(attr, cname)


# -- phase B: resolution + event extraction -------------------------------

class _Resolver:
    def __init__(self, modules: Dict[str, _ModuleInfo]):
        self.modules = modules
        # resolve singleton ctor names and self-attr types to classes
        for mod in modules.values():
            for name, ctor in list(mod.singletons.items()):
                ref = self._class_ref(mod, ctor)
                if ref is None:
                    del mod.singletons[name]
                else:
                    mod.singletons[name] = ref
            for ci in mod.classes.values():
                for attr, ctor in list(ci.attr_types.items()):
                    ref = self._class_ref(mod, ctor)
                    if ref is None:
                        del ci.attr_types[attr]
                    else:
                        ci.attr_types[attr] = ref

    def _class_ref(self, mod: _ModuleInfo, name: str) -> Optional[str]:
        if name in mod.classes:
            return "%s::%s" % (mod.dotted, name)
        imp = mod.import_names.get(name)
        if imp is not None:
            src = self.modules.get(imp[0])
            if src is not None and imp[1] in src.classes:
                return "%s::%s" % (imp[0], imp[1])
        return None

    def class_info(self, ref: str) -> Optional[_ClassInfo]:
        dotted, _, cname = ref.partition("::")
        m = self.modules.get(dotted)
        return m.classes.get(cname) if m else None

    def method(self, ref: str, name: str, depth: int = 0) -> Optional[_FuncInfo]:
        ci = self.class_info(ref)
        if ci is None or depth > 4:
            return None
        if name in ci.methods:
            return ci.methods[name]
        m = self.modules.get(ci.module)
        for base in ci.bases:
            base_ref = self._class_ref(m, base) if m else None
            if base_ref:
                fi = self.method(base_ref, name, depth + 1)
                if fi is not None:
                    return fi
        return None

    def lock_attr(self, ref: str, attr: str, depth: int = 0) -> Optional[LockDef]:
        ci = self.class_info(ref)
        if ci is None or depth > 4:
            return None
        if attr in ci.lock_attrs:
            return ci.lock_attrs[attr]
        m = self.modules.get(ci.module)
        for base in ci.bases:
            base_ref = self._class_ref(m, base) if m else None
            if base_ref:
                ld = self.lock_attr(base_ref, attr, depth + 1)
                if ld is not None:
                    return ld
        return None

    def resolve_lock(self, mod: _ModuleInfo, cls: Optional[str],
                     expr: ast.AST) -> Optional[LockDef]:
        """Resolve an expression to a LockDef, or None."""
        if isinstance(expr, ast.Name):
            if expr.id in mod.locks:
                return mod.locks[expr.id]
            imp = mod.import_names.get(expr.id)
            if imp is not None:
                src = self.modules.get(imp[0])
                if src is not None and imp[1] in src.locks:
                    return src.locks[imp[1]]
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and cls is not None:
                    return self.lock_attr("%s::%s" % (mod.dotted, cls), expr.attr)
                # module alias: fabric_mod._fabric_lock
                alias = mod.import_mods.get(base.id)
                if alias is not None:
                    src = self.modules.get(alias)
                    if src is not None and expr.attr in src.locks:
                        return src.locks[expr.attr]
                # singleton attr: METRICS._lock
                ref = self._singleton_ref(mod, base.id)
                if ref is not None:
                    return self.lock_attr(ref, expr.attr)
            elif (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
                  and base.value.id in ("self", "cls") and cls is not None):
                # self.attr._lock where self.attr has a known class type
                ci = self.class_info("%s::%s" % (mod.dotted, cls))
                if ci is not None:
                    ref = ci.attr_types.get(base.attr)
                    if ref is not None:
                        return self.lock_attr(ref, expr.attr)
        return None

    def _singleton_ref(self, mod: _ModuleInfo, name: str) -> Optional[str]:
        if name in mod.singletons:
            return mod.singletons[name]
        imp = mod.import_names.get(name)
        if imp is not None:
            src = self.modules.get(imp[0])
            if src is not None and imp[1] in src.singletons:
                return src.singletons[imp[1]]
        return None

    def resolve_call(self, mod: _ModuleInfo, cls: Optional[str],
                     node: ast.Call) -> Optional[_FuncInfo]:
        f = node.func
        if isinstance(f, ast.Name):
            name = f.id
            if name in mod.functions:
                return mod.functions[name]
            if name in mod.classes:
                return mod.classes[name].methods.get("__init__")
            imp = mod.import_names.get(name)
            if imp is not None:
                src = self.modules.get(imp[0])
                if src is not None:
                    if imp[1] in src.functions:
                        return src.functions[imp[1]]
                    if imp[1] in src.classes:
                        return src.classes[imp[1]].methods.get("__init__")
            return None
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and cls is not None:
                    return self.method("%s::%s" % (mod.dotted, cls), f.attr)
                alias = mod.import_mods.get(base.id)
                if alias is not None:
                    src = self.modules.get(alias)
                    if src is not None:
                        if f.attr in src.functions:
                            return src.functions[f.attr]
                        if f.attr in src.classes:
                            return src.classes[f.attr].methods.get("__init__")
                ref = self._singleton_ref(mod, base.id)
                if ref is not None:
                    return self.method(ref, f.attr)
                if base.id in mod.classes:
                    return mod.classes[base.id].methods.get(f.attr)
            elif (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
                  and base.value.id in ("self", "cls") and cls is not None):
                ci = self.class_info("%s::%s" % (mod.dotted, cls))
                if ci is not None:
                    ref = ci.attr_types.get(base.attr)
                    if ref is not None:
                        return self.method(ref, f.attr)
            elif (isinstance(base, ast.Call) and isinstance(base.func, ast.Name)
                  and base.func.id == "super" and cls is not None):
                ci = self.class_info("%s::%s" % (mod.dotted, cls))
                m = self.modules.get(mod.dotted)
                if ci is not None and ci.bases and m is not None:
                    bref = self._class_ref(m, ci.bases[0])
                    if bref:
                        return self.method(bref, f.attr)
        return None


class _FuncWalker:
    """Extract acquire/call/wait events from one function body, tracking
    the lexically-held lock set through `with` statements."""

    def __init__(self, res: _Resolver, mod: _ModuleInfo, fi: _FuncInfo,
                 result: LockGraphResult):
        self.res = res
        self.mod = mod
        self.fi = fi
        self.result = result
        self.events: List[_Event] = []

    def run(self) -> List[_Event]:
        node = self.fi.node
        body = node.body if hasattr(node, "body") else []
        self._walk(body, ())
        return self.events

    def _emit(self, kind: str, target: str, held: Tuple[str, ...], line: int) -> None:
        self.events.append(_Event(kind, target, held, self.mod.file, line,
                                  self.fi.qualname))

    def _walk(self, stmts: Sequence[ast.AST], held: Tuple[str, ...]) -> None:
        for st in stmts:
            self._walk_stmt(st, held)

    def _walk_stmt(self, st: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(st, ast.With):
            new_held = held
            for item in st.items:
                ld = self.res.resolve_lock(self.mod, self.fi.cls, item.context_expr)
                for e in ast.walk(item.context_expr):
                    if isinstance(e, ast.Call):
                        self._scan_call(e, new_held)
                if ld is not None:
                    self.result.sites += 1
                    if ld.lock_id in new_held and not ld.reentrant:
                        if not _line_has(self.mod, st.lineno, "lock-order-ok"):
                            self.result.findings.append(Finding(
                                "lock-reentry", self.mod.file, st.lineno,
                                "non-reentrant lock %r re-acquired while already "
                                "held in %s" % (ld.lock_id, self.fi.qualname)))
                    else:
                        self._emit("acquire", ld.lock_id, new_held, st.lineno)
                        new_held = new_held + (ld.lock_id,)
            self._walk(st.body, new_held)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: body runs later (thread target, callback) with
            # no lexical locks held
            nested = _FuncInfo("%s.<locals>.%s" % (self.fi.qualname, st.name),
                               self.fi.file, st, self.fi.cls, self.fi.module)
            w = _FuncWalker(self.res, self.mod, nested, self.result)
            w._walk(st.body, ())
            self.events.extend(w.events)
            return
        if isinstance(st, ast.Lambda):
            w = _FuncWalker(self.res, self.mod, self.fi, self.result)
            w._walk_expr_only(st.body, ())
            self.events.extend(w.events)
            return
        # generic statement: scan expressions for calls, recurse into
        # compound-statement bodies with the same held set
        for fname, value in ast.iter_fields(st):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._walk_stmt(v, held)
                    elif isinstance(v, ast.excepthandler):
                        if v.type is not None:
                            self._walk_expr_only(v.type, held)
                        self._walk(v.body, held)
                    elif isinstance(v, ast.AST):
                        self._walk_expr_only(v, held)
            elif isinstance(value, ast.AST):
                self._walk_expr_only(value, held)

    def _walk_expr_only(self, expr: ast.AST, held: Tuple[str, ...]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._scan_call(node, held)
            elif isinstance(node, (ast.Lambda,)):
                pass  # lambdas walked via ast.walk already; calls inside
                      # run later but a lexical held-set over-approximates
                      # safely only for direct bodies, so leave as-is
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                pass

    def _scan_call(self, node: ast.Call, held: Tuple[str, ...]) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "acquire":
                ld = self.res.resolve_lock(self.mod, self.fi.cls, f.value)
                if ld is not None:
                    self.result.sites += 1
                    self._emit("acquire", ld.lock_id, held, node.lineno)
                    return
            elif f.attr in ("wait", "wait_for"):
                ld = self.res.resolve_lock(self.mod, self.fi.cls, f.value)
                if ld is not None:
                    self.result.sites += 1
                    others = tuple(h for h in held if h != ld.lock_id)
                    if others and not _line_has(self.mod, node.lineno, "wait-holding-ok"):
                        self.result.findings.append(Finding(
                            "wait-while-holding", self.mod.file, node.lineno,
                            "%s waits on %r while holding %s — the held lock "
                            "is pinned for the whole wait" % (
                                self.fi.qualname, ld.lock_id, list(others))))
                    self._emit("wait", ld.lock_id, held, node.lineno)
                    return
        fi = self.res.resolve_call(self.mod, self.fi.cls, node)
        if fi is not None:
            self._emit("call", fi.qualname, held, node.lineno)


# -- graph assembly -------------------------------------------------------

def _propagate(events_by_func: Dict[str, List[_Event]]):
    """Fixpoint: for each function, the set of locks it may acquire
    (directly or transitively), with a trace for witness paths.

    trace[f][lock] = ("site", file, line) | ("via", file, line, callee)
    """
    may: Dict[str, Dict[str, Tuple]] = {f: {} for f in events_by_func}
    callers: Dict[str, Set[str]] = {}
    for f, evs in events_by_func.items():
        for e in evs:
            if e.kind == "call":
                callers.setdefault(e.target, set()).add(f)
    work = list(events_by_func.keys())
    while work:
        f = work.pop()
        cur = may.setdefault(f, {})
        changed = False
        for e in events_by_func.get(f, ()):
            if e.kind == "acquire":
                if e.target not in cur:
                    cur[e.target] = ("site", e.file, e.line)
                    changed = True
            elif e.kind == "call":
                for lock in may.get(e.target, {}):
                    if lock not in cur:
                        cur[lock] = ("via", e.file, e.line, e.target)
                        changed = True
        if changed:
            for c in callers.get(f, ()):
                if c not in work:
                    work.append(c)
    return may


def _witness_chain(may, func_or_lock_trace, events_by_func, lock: str,
                   depth: int = 0) -> List[str]:
    tr = func_or_lock_trace
    if tr is None or depth > 8:
        return []
    if tr[0] == "site":
        return ["%s:%d" % (tr[1], tr[2])]
    _via, file, line, callee = tr
    sub = may.get(callee, {}).get(lock)
    return ["%s:%d" % (file, line)] + _witness_chain(may, sub, events_by_func,
                                                    lock, depth + 1)


def _find_cycles(edges: Dict[Tuple[str, str], List[str]]) -> List[List[str]]:
    """Tarjan SCC; any SCC with >1 node (or a self-loop) is a cycle."""
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    onstack: Set[str] = set()
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v: str) -> None:
        # iterative Tarjan to dodge recursion limits on big graphs
        call_stack = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        onstack.add(v)
        while call_stack:
            node, it = call_stack[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    onstack.add(w)
                    call_stack.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in onstack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            call_stack.pop()
            if call_stack:
                parent = call_stack[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                if len(comp) > 1 or (node in graph.get(node, ())):
                    sccs.append(sorted(comp))

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def scan_sources(sources: Dict[str, Tuple[str, str]]) -> LockGraphResult:
    """Run the lock-order pass.

    `sources` maps dotted module name -> (display file path, source text).
    """
    result = LockGraphResult()
    modules: Dict[str, _ModuleInfo] = {}
    for dotted, (file, text) in sorted(sources.items()):
        mi = _collect_module(dotted, file, text)
        if mi is not None:
            modules[dotted] = mi
    result.modules = modules

    res = _Resolver(modules)
    result.resolver = res
    for mi in modules.values():
        for name, ld in mi.locks.items():
            result.locks.setdefault(ld.lock_id, ld)
        for ci in mi.classes.values():
            for ld in ci.lock_attrs.values():
                result.locks.setdefault(ld.lock_id, ld)

    events_by_func: Dict[str, List[_Event]] = {}
    for mi in modules.values():
        funcs = list(mi.functions.values())
        for ci in mi.classes.values():
            funcs.extend(ci.methods.values())
        for fi in funcs:
            w = _FuncWalker(res, mi, fi, result)
            events_by_func[fi.qualname] = w.run()

    may = _propagate(events_by_func)

    reentrant_ids = {lid for lid, ld in result.locks.items() if ld.reentrant}
    for f, evs in events_by_func.items():
        for e in evs:
            if e.kind == "acquire":
                for h in e.held:
                    if h == e.target:
                        continue
                    result.edges.setdefault((h, e.target), []).append(
                        "%s:%d" % (e.file, e.line))
            elif e.kind == "call":
                for lock, tr in may.get(e.target, {}).items():
                    for h in e.held:
                        if h == lock:
                            # same lock id via a call edge: per-instance
                            # locks share ids, so this is only a hazard
                            # for true singletons; too noisy to report
                            continue
                        chain = ["%s:%d" % (e.file, e.line)] + _witness_chain(
                            may, may.get(e.target, {}).get(lock), events_by_func, lock)
                        result.edges.setdefault((h, lock), []).append(
                            " -> ".join(chain))

    result.events = events_by_func
    result.cycles = _find_cycles(result.edges)
    for comp in result.cycles:
        comp_set = set(comp)
        lines = ["potential deadlock: lock-order cycle over %s" % (comp,)]
        first_file, first_line = "", 0
        for (a, b), wits in sorted(result.edges.items()):
            if a in comp_set and b in comp_set:
                lines.append("  %s -> %s   witness: %s" % (a, b, wits[0]))
                if not first_file:
                    head = wits[0].split(" -> ")[0]
                    first_file, _, ln = head.rpartition(":")
                    first_line = int(ln) if ln.isdigit() else 0
        result.findings.append(Finding(
            "lock-cycle", first_file or "<package>", first_line,
            "\n".join(lines)))
    return result
