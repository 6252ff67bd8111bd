"""Shared AST analysis: where does device code live in the port?

The torch counterpart of ``tools/kafkalint/jitscan.py``.  The port
compiles nothing by trace, so a JAX *jit region* has no twin; what it
has is a *device region*, code that runs per pixel on the device inside
a transform or a hand kernel's launch:

- a callable handed to a ``torch.func`` transform (``vmap`` /
  ``jacfwd`` / ``jacrev`` / ``jvp`` / ``vjp`` / ``grad`` /
  ``hessian`` / ``functional_call``, imported from ``torch.func`` under
  any alias), resolved through ``functools.partial`` and nested
  transforms to a ``Lambda`` or a ``def``.  A same-module name resolves
  to that module's defs; ``self.<method>`` resolves to every method of
  that name in the scanned tree, since the protocol hands each
  operator's override to the transform (``ObservationModel.linearize``
  vmaps ``self.forward_pixel``);
- the body of a ``with ... kernel_region(...)`` block;
- a def that launches a hand kernel: its body calls
  ``core._build.count_launch`` or enters ``kernel_region`` (the
  wrappers in ``core/fused_gn.py``, ``core/fused_update.py``,
  ``core/solve_rows.py``);
- anything lexically nested inside one of the above;
- and, unlike ``jitscan``, every def a transform's region calls: a
  same-module or imported function, or ``self.<method>`` as above.
  Eager torch has no trace boundary, so a helper called from a
  linearised forward model runs inside the transform; the closure
  follows calls across the scanned modules (:class:`TreeIndex`).  A
  launch site's callees (the kernel build, the launch geometry) are
  host plumbing and stay outside.

Unresolvable targets (callables built elsewhere, methods of other
receivers) are skipped — this is a convention lint, not a soundness
proof.  The module reads source text only and imports neither ``torch``
nor ``jax``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

#: ``torch.func`` transforms whose first argument runs as a device
#: region.
TRANSFORM_TAILS = {
    "vmap", "jacfwd", "jacrev", "jvp", "vjp", "grad", "grad_and_value",
    "hessian", "functional_call",
}

#: calls that mark a def as a hand kernel's launch site.
LAUNCH_TAILS = {"count_launch", "kernel_region"}

#: the module that defines the launch plumbing itself.
BUILD_MODULE = "kafka_tpu_torch/core/_build.py"


def nodes(tree: ast.AST) -> List[ast.AST]:
    """Every node of ``tree`` in ``ast.walk`` order, walked once and kept
    on the tree: the rules here read each module many times."""
    cached = getattr(tree, "_kafkalint_nodes", None)
    if cached is None:
        cached = list(ast.walk(tree))
        tree._kafkalint_nodes = cached
    return cached


def dotted(node: ast.AST) -> Optional[str]:
    """``torch.func.vmap`` for the matching Attribute/Name chain, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def tail(node: ast.AST) -> Optional[str]:
    d = dotted(node)
    return d.rsplit(".", 1)[-1] if d else None


def collect_defs(tree: ast.AST) -> Dict[str, FuncNode]:
    """Every named def in the module (methods included), by bare name.
    Later defs shadow earlier same-named ones — good enough for
    resolving ``target=`` references."""
    defs: Dict[str, FuncNode] = {}
    for node in nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    return defs


def resolve_callable(node: ast.AST,
                     defs: Dict[str, FuncNode]) -> List[FuncNode]:
    """Resolve an expression used as a callable to def/lambda nodes."""
    if isinstance(node, ast.Lambda):
        return [node]
    if isinstance(node, (ast.Name, ast.Attribute)):
        t = tail(node)
        return [defs[t]] if t in defs else []
    if isinstance(node, ast.Call) and node.args:
        t = tail(node.func)
        if t == "partial" or t in TRANSFORM_TAILS:
            return resolve_callable(node.args[0], defs)
    return []


# ---------------------------------------------------------------------------
# Module aliases.
# ---------------------------------------------------------------------------

def numpy_aliases(tree: ast.AST) -> Set[str]:
    """Module-level names bound to the ``numpy`` package."""
    aliases = set()
    for node in nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    aliases.add(a.asname or "numpy")
    return aliases or {"np", "numpy"} & _names_used(tree)


def torch_aliases(tree: ast.AST) -> Set[str]:
    """Names bound to the ``torch`` package (``import torch [as t]``);
    ``torch`` itself always counts."""
    aliases = {"torch"}
    for node in nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" and a.asname:
                    aliases.add(a.asname)
    return aliases


def func_aliases(tree: ast.AST) -> Tuple[Dict[str, str], Set[str]]:
    """(bare name -> transform, module aliases) for ``torch.func``:
    ``from torch.func import vmap as v`` gives ``{"v": "vmap"}``;
    ``from torch import func`` / ``import torch.func as tf`` give the
    module aliases ``func`` / ``tf`` (``torch.func`` itself always
    counts)."""
    names: Dict[str, str] = {}
    modules = {f"{t}.func" for t in torch_aliases(tree)}
    for node in nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "torch.func":
                for a in node.names:
                    if a.name in TRANSFORM_TAILS:
                        names[a.asname or a.name] = a.name
            elif node.module == "torch":
                for a in node.names:
                    if a.name == "func":
                        modules.add(a.asname or "func")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.func" and a.asname:
                    modules.add(a.asname)
    return names, modules


def transform_of(call: ast.Call, names: Dict[str, str],
                 modules: Set[str]) -> Optional[str]:
    """The ``torch.func`` transform ``call`` applies, else None."""
    f = call.func
    if isinstance(f, ast.Name):
        return names.get(f.id)
    if isinstance(f, ast.Attribute) and f.attr in TRANSFORM_TAILS:
        base = dotted(f.value)
        if base in modules:
            return f.attr
    return None


def _names_used(tree: ast.AST) -> set:
    return {n.id for n in nodes(tree) if isinstance(n, ast.Name)}


# ---------------------------------------------------------------------------
# Device regions.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Region:
    """One device region: the statements that run on the device, the
    names bound inside them (the values a host read there reads from
    the device), and how the region became one."""

    name: str
    rel: str
    stmts: List[ast.AST]
    via: str
    func: Optional[FuncNode] = None
    #: whether the defs this region calls are device regions too (a
    #: transform's; not a launch site's).
    closure: bool = True


def region_locals(func: FuncNode) -> set:
    """Names bound inside the region: parameters of the root and of every
    nested def/lambda, plus local assignment/loop/with targets.  These are
    the names a host read of which is (conservatively) a device value;
    closure reads from outside the region are not included."""
    names: set = set()

    def add_args(fn: FuncNode) -> None:
        a = fn.args
        for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            names.add(arg.arg)
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)

    add_args(func)
    body = func.body if isinstance(func.body, list) else [func.body]
    names |= _bound_in(body, add_args)
    names.discard("self")
    return names


def _bound_in(stmts: Iterable[ast.AST], add_args=None) -> set:
    names: set = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                if add_args is not None:
                    add_args(node)
                continue
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                                   ast.NamedExpr, ast.For, ast.AsyncFor)):
                targets = [node.target]
            elif isinstance(node, ast.withitem) and \
                    node.optional_vars is not None:
                targets = [node.optional_vars]
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
    return names


def traced_names(region: Region) -> set:
    """Names a host read inside ``region`` reads from the device."""
    if region.func is not None:
        return region_locals(region.func)
    return _bound_in(region.stmts)


def _body(func: FuncNode) -> List[ast.AST]:
    return func.body if isinstance(func.body, list) else [func.body]


def launch_defs(tree: ast.AST, rel: str) -> List[FuncNode]:
    """Defs whose body (nested defs included) calls ``count_launch`` or
    enters ``kernel_region``, in walk order (the launch plumbing module
    itself excluded)."""
    if rel == BUILD_MODULE:
        return []
    lines = [node.lineno for node in nodes(tree)
             if isinstance(node, ast.Call) and tail(node.func) in
             LAUNCH_TAILS]
    return [node for node in nodes(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(node.lineno <= ln <= node.end_lineno for ln in lines)]


def _module_rel(rel: str, level: int, module: Optional[str]) -> str:
    """Root-relative module path prefix (no ``.py``) of an import."""
    if level:
        base = rel.split("/")[:-level]
    else:
        base = []
    parts = base + (module.split(".") if module else [])
    return "/".join(parts)


class ModuleScan:
    """One module's regions and call targets (per-file half of the
    closure)."""

    def __init__(self, rel: str, tree: ast.AST):
        self.rel = rel
        self.tree = tree
        #: functions a bare name can call (module-level and nested
        #: defs), and methods (reached through ``self``), by name.
        self.defs: Dict[str, List[FuncNode]] = {}
        self.methods: Dict[str, List[FuncNode]] = {}
        for node in nodes(tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self.methods.setdefault(item.name, []).append(item)
        method_ids = {id(fn) for fns in self.methods.values() for fn in fns}
        for node in nodes(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(node) not in method_ids:
                self.defs.setdefault(node.name, []).append(node)
        #: local name -> (module path without .py, name there).
        self.imports: Dict[str, Tuple[str, str]] = {}
        for node in nodes(tree):
            if isinstance(node, ast.ImportFrom):
                mod = _module_rel(rel, node.level, node.module)
                for a in node.names:
                    self.imports[a.asname or a.name] = (mod, a.name)
        self.func_names, self.func_modules = func_aliases(tree)
        #: roots: (func or None, stmts, via); method names handed to a
        #: transform as ``self.<name>`` (resolved across the tree).
        self.roots: List[Region] = []
        self.method_roots: List[Tuple[str, str]] = []
        self._find_roots()

    def _add_target(self, node: ast.AST, via: str) -> None:
        if isinstance(node, ast.Lambda):
            self.roots.append(Region("<lambda>", self.rel, _body(node),
                                     via, node))
        elif isinstance(node, ast.Name):
            for fn in self.defs.get(node.id, []):
                self.roots.append(Region(fn.name, self.rel, _body(fn),
                                         via, fn))
        elif isinstance(node, ast.Attribute):
            base = dotted(node.value) or ""
            if base.split(".")[0] == "self":
                self.method_roots.append((node.attr, via))
        elif isinstance(node, ast.Call) and node.args:
            t = tail(node.func)
            if t == "partial" or transform_of(
                    node, self.func_names, self.func_modules):
                self._add_target(node.args[0], via)

    def _find_roots(self) -> None:
        for node in nodes(self.tree):
            if isinstance(node, ast.Call):
                t = transform_of(node, self.func_names, self.func_modules)
                if t and node.args:
                    self._add_target(node.args[0], f"torch.func.{t}")
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(item.context_expr, ast.Call)
                       and tail(item.context_expr.func) == "kernel_region"
                       for item in node.items):
                    self.roots.append(Region(
                        "kernel_region", self.rel, list(node.body),
                        "with kernel_region(...)", closure=False))
        for fn in launch_defs(self.tree, self.rel):
            self.roots.append(Region(fn.name, self.rel, _body(fn),
                                     "hand-kernel launch", fn,
                                     closure=False))

    def callees(self, stmts: List[ast.AST]
                ) -> Tuple[List[Tuple[str, str]], List[str]]:
        """Calls made by ``stmts``: (module path, name) of plain-name
        calls (this module's or imported), and method names called on
        ``self``."""
        plain: List[Tuple[str, str]] = []
        methods: List[str] = []
        for stmt in stmts:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name):
                    if f.id in self.defs:
                        plain.append((self.rel[:-3], f.id))
                    elif f.id in self.imports:
                        plain.append(self.imports[f.id])
                elif isinstance(f, ast.Attribute):
                    base = dotted(f.value) or ""
                    if base.split(".")[0] == "self":
                        methods.append(f.attr)
                    elif base in self.imports:
                        # ``mod.fn(...)`` after ``from . import mod``.
                        mod, name = self.imports[base]
                        plain.append((f"{mod}/{name}", f.attr))
        return plain, methods


class TreeIndex:
    """Every scanned module's :class:`ModuleScan`, and the device
    regions of the whole tree: the roots plus every def they reach."""

    def __init__(self) -> None:
        self.modules: Dict[str, ModuleScan] = {}

    def add(self, rel: str, tree: ast.AST) -> ModuleScan:
        scan = ModuleScan(rel, tree)
        self.modules[rel] = scan
        return scan

    def _module(self, path: str) -> Optional[ModuleScan]:
        return (self.modules.get(path + ".py")
                or self.modules.get(path + "/__init__.py"))

    def _defs_named(self, path: str, name: str) -> List[Tuple[str, FuncNode]]:
        scan = self._module(path)
        if scan is None:
            return []
        if name in scan.defs:
            return [(scan.rel, fn) for fn in scan.defs[name]]
        if name in scan.imports:  # re-export through a package
            mod, orig = scan.imports[name]
            if (mod, orig) != (path, name):
                return self._defs_named(mod, orig)
        return []

    def _methods_named(self, name: str) -> List[Tuple[str, FuncNode]]:
        return [(rel, fn) for rel, scan in sorted(self.modules.items())
                for fn in scan.methods.get(name, [])]

    def regions(self) -> List[Region]:
        """Every device region, each def once (roots first)."""
        out: List[Region] = []
        seen: Set[int] = set()
        work: List[Region] = []
        for rel in sorted(self.modules):
            scan = self.modules[rel]
            work.extend(scan.roots)
            for name, via in scan.method_roots:
                for mrel, fn in self._methods_named(name):
                    work.append(Region(fn.name, mrel, _body(fn),
                                       f"{via} of self.{name}", fn))
        while work:
            region = work.pop(0)
            key = id(region.func) if region.func is not None \
                else id(region.stmts[0])
            if key in seen:
                continue
            seen.add(key)
            out.append(region)
            if not region.closure:
                continue
            scan = self.modules[region.rel]
            plain, methods = scan.callees(region.stmts)
            via = f"called from {region.name}"
            for path, name in plain:
                for rel, fn in self._defs_named(path, name):
                    work.append(Region(fn.name, rel, _body(fn), via, fn))
            for name in methods:
                for rel, fn in self._methods_named(name):
                    work.append(Region(fn.name, rel, _body(fn), via, fn))
        return out
