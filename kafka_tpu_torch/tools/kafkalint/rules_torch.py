"""Device-path hazard rules in the torch idiom: host transfers in device
regions, implicit float64, Jacobian relayouts, non-finite laundering.

The counterparts of ``tools/kafkalint/rules_jax.py``.  They encode the
same conventions: exactly one device->host read per window, so no hidden
transfer may hide inside the per-pixel device code; the parity budgets
hold only while device math stays float32; a dense Jacobian relayout is
an extra pass over memory the fused kernels exist to delete; a
non-finite value is replaced only where a solve-health verdict records
it.  Each JAX construct is translated to the PyTorch construct that
carries the same hazard:

- ``host-transfer-in-jit`` keeps its name (a suppression reads the same
  in both packages); "jit" means a device region (``torchscan``).  In a
  region it flags ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a region value,
  and ``torch.tensor`` / ``torch.as_tensor`` with a ``device=`` argument
  (a host value copied to the device: one blocking copy, a sync on the
  card, per call).  In a device-code module it also flags the explicit
  reads outside regions: each is a sync, and the engine's one read per
  window goes through ``telemetry/device.py:fetch_scalars``, which is
  exempt as ``device_get`` is at its sanctioned site.  The JAX rule's
  ``np.*`` half has no twin: a numpy call on a CUDA tensor raises rather
  than folding silently.
- ``implicit-f64`` flags ``torch.float64`` / ``torch.double`` (any
  ``.float64`` attribute, ``np.float64`` included), ``.double()``,
  ``dtype=float`` and the ``"float64"`` string in device-code modules,
  and ``torch.from_numpy`` / ``torch.as_tensor`` of a numpy array built
  without a dtype (numpy's default float is float64).  The JAX rule's
  other half, a dtype-less ``jnp.asarray`` of a Python float literal,
  is replaced rather than copied: torch's default dtype is float32, so
  a literal never promotes.
- ``kernel-relayout`` flags ``.transpose`` / ``.permute`` / ``.mT`` /
  ``.reshape`` / ``.contiguous()`` (and the ``torch.*`` forms) of a
  Jacobian tensor in ``core/`` outside ``jac_to_rows``.
- ``nonfinite-launder`` flags ``torch.nan_to_num`` (function or method)
  and ``torch.where`` whose condition probes ``isnan`` / ``isfinite`` /
  ``isinf`` outside ``core/solver_health.py``.

``static-arg-flag`` has no counterpart and is dropped: it guards the
static arguments of a jitted function (a bool or str flag not marked
static retraces on every value), and the port compiles nothing by trace
— its entry points are eager functions, and a flag is a Python value
read at call time.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from .core import FileContext, Finding, Rule, register
from . import torchscan

#: packages whose modules hold device code.  Everything else — io
#: readers, cli drivers, telemetry, testing, tools — is host side, where
#: float64 is often *correct* (geolocation, emulator import).
DEVICE_PREFIXES = (
    "kafka_tpu_torch/core/",
    "kafka_tpu_torch/shard/",
    "kafka_tpu_torch/obsops/",
    "kafka_tpu_torch/engine/",
)
#: ``chip_smoke.py`` is left out, unlike ``bench.py`` in the JAX rule:
#: the card harness holds each kernel to float64 runs of its plain
#: version by design, and its host reads are its gates.
DEVICE_FILES: tuple = ()

#: host-side modules inside device packages: f64 is deliberate there.
HOST_ALLOWLIST = {
    # Emulator import: K can be ill-conditioned, the solve is f64 on host
    # and the bank is cast to f32 at the end (obsops/gp_import.py).
    "kafka_tpu_torch/obsops/gp_import.py",
    # Published-spectra anchor tables, band-averaged once at import by
    # plain numpy; never on the device.
    "kafka_tpu_torch/obsops/prospect_data.py",
    # Geolocation/warp math is host-side numpy where f64 precision is the
    # point (sub-pixel UTM/sinusoidal transforms).
    "kafka_tpu_torch/io/warp.py",
}

#: the sanctioned device->host read: ``fetch_scalars`` in this module.
SANCTIONED_READ = ("kafka_tpu_torch/telemetry/device.py", "fetch_scalars")

#: tensor methods that read device memory to the host (blocking).
READ_METHODS = {"item", "tolist", "cpu", "numpy"}


def is_device_module(rel: str) -> bool:
    if rel in HOST_ALLOWLIST:
        return False
    return rel in DEVICE_FILES or rel.startswith(DEVICE_PREFIXES)


def _shielded(node: ast.AST, traced: set) -> bool:
    """True when ``node`` reads no region value: constants, or names
    only reached through the host-side accessors ``.shape`` / ``.ndim``
    / ``.dtype`` / ``len()`` / ``.numel()``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in traced:
            if not _under_static_accessor(node, sub):
                return False
    return True


def _under_static_accessor(root: ast.AST, target: ast.Name) -> bool:
    """Is ``target`` only reachable through a host-side accessor within
    ``root``?"""

    class V(ast.NodeVisitor):
        found_bare = False

        def visit_Attribute(self, node: ast.Attribute) -> None:
            if node.attr in ("shape", "ndim", "dtype", "device"):
                return  # host metadata; don't descend
            self.generic_visit(node)

        def visit_Call(self, node: ast.Call) -> None:
            if isinstance(node.func, ast.Name) and node.func.id == "len":
                return
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("size", "numel", "dim"):
                return
            self.generic_visit(node)

        def visit_Name(self, node: ast.Name) -> None:
            if node is target:
                self.found_bare = True

    v = V()
    v.visit(root)
    return not v.found_bare


def _copy_to_device(call: ast.Call, torch_names: set) -> str:
    """``torch.tensor(...)`` / ``torch.as_tensor(...)`` with a
    ``device=`` keyword, named; else ''."""
    f = call.func
    if not (isinstance(f, ast.Attribute)
            and f.attr in ("tensor", "as_tensor")
            and isinstance(f.value, ast.Name)
            and f.value.id in torch_names):
        return ""
    if any(kw.arg == "device" for kw in call.keywords):
        return f"{f.value.id}.{f.attr}(..., device=...)"
    return ""


@register
class HostTransferInJit(Rule):
    name = "host-transfer-in-jit"
    description = (
        ".item()/.tolist()/.cpu()/.numpy(), float()/int()/bool() of a "
        "device value and torch.tensor/as_tensor(..., device=) copies "
        "inside device regions (torch.func transform bodies and what "
        "they call, hand-kernel launch sites), and explicit reads in "
        "device-code modules — each is a hidden device<->host transfer "
        "that breaks the one-read-per-window budget"
    )

    def __init__(self) -> None:
        self.index = torchscan.TreeIndex()
        self.torch_names = {}
        self.contexts = {}

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None:
            return ()
        self.index.add(ctx.rel, ctx.tree)
        self.torch_names[ctx.rel] = torchscan.torch_aliases(ctx.tree)
        self.contexts[ctx.rel] = ctx
        return ()

    def finalize(self) -> Iterable[Finding]:
        findings: List[Finding] = []
        seen = set()

        def flag(rel: str, node: ast.AST, msg: str) -> None:
            key = (rel, node.lineno)
            if key in seen:
                return
            seen.add(key)
            findings.append(Finding(path=rel, line=node.lineno,
                                    rule=self.name, message=msg))

        region_lines = set()
        for region in self.index.regions():
            if (region.rel, region.name) == SANCTIONED_READ:
                continue
            traced = torchscan.traced_names(region)
            torch_names = self.torch_names[region.rel]
            where = (f"inside device region '{region.name}' "
                     f"({region.via})")
            # float()/int()/bool() of a transform's values only: a
            # launch site's arguments are mostly host options.
            traced = traced if region.closure else set()
            for stmt in region.stmts:
                for node in ast.walk(stmt):
                    region_lines.add((region.rel, getattr(
                        node, "lineno", 0)))
                    if not isinstance(node, ast.Call):
                        continue
                    what = self._host_read(node, traced)
                    if what:
                        flag(region.rel, node, (
                            f"{what} {where} — a hidden device->host "
                            "read (a sync on the card); keep the value "
                            "on the device and hoist host work out of "
                            "the region"
                        ))
                        continue
                    copy = _copy_to_device(node, torch_names)
                    if copy:
                        flag(region.rel, node, (
                            f"{copy} of a host value {where} — one "
                            "blocking host->device copy per call; make "
                            "the constant on the device (torch.full) "
                            "or once per device, outside the region"
                        ))
        for rel, ctx in sorted(self.contexts.items()):
            if not is_device_module(rel):
                continue
            for node in torchscan.nodes(ctx.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in READ_METHODS
                        and not node.args and not node.keywords
                        and (rel, node.lineno) not in region_lines):
                    flag(rel, node, (
                        f".{node.func.attr}() in a device-code module "
                        "— an explicit device->host read (a sync on "
                        "the card) outside the sanctioned "
                        "telemetry.device.fetch_scalars; read through "
                        "it, once per window, or justify the read "
                        "inline"
                    ))
        return findings

    @staticmethod
    def _host_read(node: ast.Call, traced: set) -> str:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in READ_METHODS \
                and not node.args:
            return f".{f.attr}()"
        if (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                and node.args and not _shielded(node.args[0], traced)):
            return f"{f.id}() of a device value"
        return ""


def _names_dtype(node: ast.AST) -> bool:
    """``np.float32`` / ``"float32"`` / ``torch.int64``: an argument
    that names a dtype (numpy's positional dtype)."""
    name = node.value if isinstance(node, ast.Constant) else \
        torchscan.tail(node)
    return isinstance(name, str) and name.rstrip("_").startswith(
        ("float", "int", "uint", "bool", "complex"))


_NUMPY_FLOAT_MAKERS = {
    "array", "asarray", "linspace", "arange", "zeros", "ones", "full",
    "empty", "eye", "loadtxt", "genfromtxt",
}


@register
class ImplicitF64(Rule):
    name = "implicit-f64"
    description = (
        "float64 in device-code modules (torch.float64/torch.double, "
        ".double(), dtype=float, 'float64', torch.from_numpy/as_tensor "
        "of a dtype-less numpy array) — device math is float32-only "
        "(the parity budgets); host-side modules (io/warp.py, "
        "obsops/gp_import.py, ...) are allowlisted because f64 is "
        "correct there"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or not is_device_module(ctx.rel):
            return ()
        torch_names = torchscan.torch_aliases(ctx.tree)
        np_names = torchscan.numpy_aliases(ctx.tree)
        findings: List[Finding] = []

        def flag(node: ast.AST, msg: str) -> None:
            findings.append(Finding(
                path=ctx.rel, line=node.lineno, rule=self.name,
                message=msg,
            ))

        # ``x.double()`` is the method form, reported once as a call.
        call_targets = {id(c.func) for c in torchscan.nodes(ctx.tree)
                        if isinstance(c, ast.Call)}
        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in ("float64", "double") and \
                    id(node) not in call_targets:
                base = torchscan.dotted(node.value) or "?"
                if node.attr == "double" and base not in torch_names:
                    continue
                flag(node, (
                    f"{base}.{node.attr} in a device-code module — "
                    "device math is float32-only; compute in f32 or "
                    "move this to a host-side module (allowlisted in "
                    "kafka_tpu_torch/tools/kafkalint/rules_torch.py)"
                ))
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "double" \
                        and not node.args:
                    flag(node, (
                        ".double() in a device-code module — a float64 "
                        "copy; device math is float32-only"
                    ))
                for kw in node.keywords:
                    if kw.arg == "dtype" and isinstance(kw.value, ast.Name) \
                            and kw.value.id == "float":
                        flag(kw.value, (
                            "dtype=float in a device-code module — "
                            "Python's float is float64 to torch and "
                            "numpy; name torch.float32"
                        ))
                for arg in (*node.args,
                            *(kw.value for kw in node.keywords)):
                    if (isinstance(arg, ast.Constant)
                            and arg.value == "float64"):
                        flag(arg, (
                            "dtype \"float64\" in a device-code module "
                            "— device math is float32-only"
                        ))
                self._check_from_numpy(node, torch_names, np_names, flag)
        return findings

    @staticmethod
    def _check_from_numpy(node: ast.Call, torch_names: set,
                          np_names: set, flag) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("from_numpy", "as_tensor")
                and isinstance(f.value, ast.Name)
                and f.value.id in torch_names and node.args):
            return
        if any(kw.arg == "dtype" for kw in node.keywords):
            return
        arg = node.args[0]
        if not (isinstance(arg, ast.Call)
                and isinstance(arg.func, ast.Attribute)
                and isinstance(arg.func.value, ast.Name)
                and arg.func.value.id in np_names
                and arg.func.attr in _NUMPY_FLOAT_MAKERS):
            return
        if any(kw.arg == "dtype" for kw in arg.keywords) or any(
                _names_dtype(a) for a in arg.args[1:]):
            return
        flag(node, (
            f"{f.value.id}.{f.attr}() of a dtype-less "
            f"{arg.func.value.id}.{arg.func.attr}() — numpy's default "
            "float is float64 and the tensor keeps it; pass "
            "dtype=torch.float32"
        ))


#: the one function allowed to relayout a dense Jacobian batch — the
#: shim for operators without an in-kernel linearisation
#: (core/fused_update.py).
RELAYOUT_SHIM = "jac_to_rows"

_RELAYOUT_FUNCS = {"transpose", "permute", "reshape", "movedim",
                   "moveaxis", "swapaxes", "contiguous"}


@register
class KernelRelayout(Rule):
    name = "kernel-relayout"
    description = (
        ".transpose/.permute/.mT/.reshape/.contiguous() (or the torch.* "
        "forms) of a (B, n, p) Jacobian tensor in core/ outside the "
        "sanctioned jac_to_rows shim — every such relayout is an extra "
        "pass over device memory the fused kernels exist to delete; "
        "operators should advertise inkernel_linearize (rows born in "
        "lane layout) or route through the shim"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or \
                not ctx.rel.startswith("kafka_tpu_torch/core/"):
            return ()
        torch_names = torchscan.torch_aliases(ctx.tree)
        findings: List[Finding] = []
        seen_lines = set()

        def mentions_jac(node: ast.AST) -> bool:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and "jac" in sub.id.lower():
                    return True
                if isinstance(sub, ast.Attribute) and \
                        "jac" in sub.attr.lower():
                    return True
            return False

        def flag(node: ast.AST, what: str) -> None:
            if node.lineno in seen_lines:
                return  # one finding per relayout chain/line
            seen_lines.add(node.lineno)
            findings.append(Finding(
                path=ctx.rel, line=node.lineno, rule=self.name,
                message=(
                    f"{what} on a Jacobian tensor outside the sanctioned "
                    f"{RELAYOUT_SHIM} shim — a dense (B, n, p) relayout "
                    "is an extra pass over device memory; use the shim "
                    "(out-of-kernel operators) or kernel_linearize_rows "
                    "(in-kernel lane-layout Jacobians)"
                ),
            ))

        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == RELAYOUT_SHIM:
                # the shim itself: its body is the one sanctioned use.
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.Call, ast.Attribute)):
                        seen_lines.add(sub.lineno)
        for node in torchscan.nodes(ctx.tree):
            if isinstance(node, ast.Attribute) and node.attr == "mT" \
                    and mentions_jac(node.value):
                flag(node, ".mT")
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in _RELAYOUT_FUNCS):
                continue
            if isinstance(f.value, ast.Name) and f.value.id in torch_names:
                # module form: torch.permute(jac, ...) — the jac mention
                # lives in the arguments.
                if mentions_jac(node):
                    flag(node, f"{f.value.id}.{f.attr}()")
            elif mentions_jac(f.value):
                # method form: lin.jac.reshape(...) / jac.permute(...)
                flag(node, f".{f.attr}() method")
        return findings


#: the one module allowed to select non-finite values away in device
#: code — every replacement there is paired with a solve-health verdict
#: (retreat flags feed escalation; quarantine selects set QA bits).
NONFINITE_SANCTUARY = "kafka_tpu_torch/core/solver_health.py"

_NONFINITE_PROBES = {"isnan", "isfinite", "isinf"}


@register
class NonfiniteLaunder(Rule):
    name = "nonfinite-launder"
    description = (
        "torch.nan_to_num, or torch.where whose condition probes "
        "isnan/isfinite/isinf, outside core/solver_health.py — "
        "replacing a non-finite value with a plausible number without "
        "raising a solve-health verdict is exactly the silent per-pixel "
        "divergence the health layer exists to end; detect through "
        "solver_health helpers so the replacement carries a QA bit"
    )

    def check_file(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.tree is None or ctx.rel == NONFINITE_SANCTUARY:
            return ()
        torch_names = torchscan.torch_aliases(ctx.tree)
        np_names = torchscan.numpy_aliases(ctx.tree)
        findings: List[Finding] = []

        def probes_nonfinite(node: ast.AST) -> bool:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Attribute) and \
                        sub.func.attr in _NONFINITE_PROBES:
                    return True
            return False

        for node in torchscan.nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            base = torchscan.dotted(f.value) or ""
            module_form = base in torch_names
            if f.attr in ("nan_to_num", "nan_to_num_") and \
                    base not in np_names:
                # torch.nan_to_num(x) or the method x.nan_to_num();
                # numpy's host-side twin is out of scope.
                findings.append(Finding(
                    path=ctx.rel, line=node.lineno, rule=self.name,
                    message=(
                        f"{base if module_form else ''}.{f.attr}() "
                        "launders NaN/inf into plausible numbers with "
                        "no verdict — route the replacement through "
                        "core/solver_health.py so the pixel is flagged"
                    ),
                ))
            elif module_form and f.attr == "where" and node.args and \
                    probes_nonfinite(node.args[0]):
                findings.append(Finding(
                    path=ctx.rel, line=node.lineno, rule=self.name,
                    message=(
                        f"{base}.where() on an isnan/isfinite "
                        "probe silently launders non-finite values — "
                        "use the sanctioned solver_health selects "
                        "(retreat/quarantine_select), which pair every "
                        "replacement with a QA verdict"
                    ),
                ))
        return findings
