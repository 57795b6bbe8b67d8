"""Contract lint: AST rules for the port's recurring contracts.

The counterpart of ``repro/verify/lint.py``, its five rules aimed at
``repro_torch``:

* ``unbounded-cache`` -- every ``functools.lru_cache`` passes a finite
  ``maxsize`` (``functools.cache`` and ``maxsize=None`` grow without
  bound under shape churn; serving replans would leak).
* ``nameless-plan-error`` -- every ``raise PlanError(...)`` formats its
  message (an f-string, ``.format`` or a concatenation naming the op); a
  bare string constant cannot name the offending op or config.
* ``unfaulted-wrapper`` -- every public function of ``kernels/ops.py``
  that calls a kernel-module alias (a name imported from
  ``repro_torch.kernels`` bound with a leading underscore) carries a
  ``faults.corrupt_array`` site, so the chaos suite reaches every
  executor.  Pure planning helpers call no alias and are exempt by that
  alone: there is no other exemption hook.
* ``unjitted-custom-vjp-wrapper`` -- every public wrapper around a
  same-module ``torch.autograd.Function`` calls its ``.apply``.  Calling
  ``Fn.forward`` (or ``backward``) directly runs the kernel with no
  autograd node and drops the gradient without a word: the port's
  counterpart of the reference's un-jitted wrapper that re-traces.
* ``eager-compute-in-kernel`` -- no ``F.conv*`` anywhere under
  ``kernels/`` (the plan-driven im2col kernels replaced it; one that
  came back would bypass the ExecutionPlan), and no library compute
  (``torch.matmul``, ``@``, ``einsum``, ``F.linear``,
  ``F.scaled_dot_product_attention``) inside a function that launches a
  ``build.Kernel``: that function is the port's counterpart of a kernel
  body.  The plain twins (``*_plain``, ``ref.py``) launch nothing, so the
  rule does not reach them, and they need no exemption.

Pure ``ast``: it imports nothing it lints, so the seeded-violation tests
lint source strings directly.  ``python -m repro_torch.verify --lint-only``
runs it over the package.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Sequence

_ALL_ROLES = frozenset({"ops", "kernels"})
# Library calls that compute what a kernel of the port computes.
_LIBRARY_COMPUTE = frozenset({"matmul", "mm", "bmm", "addmm", "einsum",
                              "linear", "scaled_dot_product_attention"})


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``torch.nn.functional``)."""
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _decorator_names(fn: ast.FunctionDef) -> list[tuple[str, ast.expr]]:
    """(dotted name, node) per decorator; for ``functools.partial(f, ..)``
    the name reported is f's."""
    out = []
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            name = _dotted(dec.func)
            if name.endswith("partial") and dec.args:
                out.append((_dotted(dec.args[0]), dec))
                continue
            out.append((name, dec))
        else:
            out.append((_dotted(dec), dec))
    return out


def _calls_in(fn: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            yield node


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _functions(tree: ast.AST) -> Iterable[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------------------
# Individual rules
# ---------------------------------------------------------------------------

def _rule_unbounded_cache(tree: ast.Module, path: str) -> list[LintViolation]:
    out = []
    for node in _functions(tree):
        for name, dec in _decorator_names(node):
            short = name.rsplit(".", 1)[-1]
            if short == "cache" and name in ("functools.cache", "cache"):
                out.append(LintViolation(
                    path, dec.lineno, "unbounded-cache",
                    f"{node.name}: functools.cache is unbounded; use "
                    f"lru_cache(maxsize=N)"))
            if short != "lru_cache":
                continue
            bounded = False
            if isinstance(dec, ast.Call):
                for kw in dec.keywords:
                    if kw.arg == "maxsize" and not (
                            isinstance(kw.value, ast.Constant)
                            and kw.value.value is None):
                        bounded = True
                if dec.args and not (isinstance(dec.args[0], ast.Constant)
                                     and dec.args[0].value is None):
                    bounded = True
            if not bounded:
                out.append(LintViolation(
                    path, dec.lineno, "unbounded-cache",
                    f"{node.name}: lru_cache without a finite maxsize"))
    return out


def _rule_nameless_plan_error(tree: ast.Module,
                              path: str) -> list[LintViolation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Raise) or node.exc is None:
            continue
        exc = node.exc
        if not (isinstance(exc, ast.Call)
                and _dotted(exc.func).rsplit(".", 1)[-1] == "PlanError"):
            continue
        if not exc.args:
            out.append(LintViolation(
                path, node.lineno, "nameless-plan-error",
                "PlanError raised without a message"))
            continue
        first = exc.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            out.append(LintViolation(
                path, node.lineno, "nameless-plan-error",
                f"PlanError message {first.value!r} is a bare constant -- "
                f"format the op/config name into it"))
    return out


def _is_library_conv(dotted: str) -> bool:
    """``F.conv2d``, ``torch.nn.functional.conv1d``, ``torch.conv2d``..."""
    prefix, _, leaf = dotted.rpartition(".")
    return leaf.startswith("conv") and (
        prefix in ("F", "torch") or prefix.endswith("functional"))


def _kernel_names(tree: ast.Module) -> set[str]:
    """Module-level names bound to a ``build.Kernel`` (``X = Kernel(...)``),
    and to a container of them (a dict of entries by mode)."""
    kernels: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _dotted(node.value.func).rsplit(".", 1)[-1] == "Kernel":
            kernels |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    for node in tree.body:
        if isinstance(node, ast.Assign) and _names_in(node.value) & kernels:
            kernels |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return kernels


def _local_aliases(fn: ast.AST, kernels: set[str]) -> set[str]:
    """Names a function binds to one of ``kernels`` (``entry = K4 if ...
    else K3``; ``entry, args = K13, [...]``)."""
    aliases = set(kernels)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Tuple) \
                    and isinstance(node.value, ast.Tuple) \
                    and len(target.elts) == len(node.value.elts):
                pairs = zip(target.elts, node.value.elts)
            else:
                pairs = [(target, node.value)]
            for tgt, val in pairs:
                if isinstance(tgt, ast.Name) and _names_in(val) & aliases:
                    aliases.add(tgt.id)
    return aliases


def _launchers(tree: ast.Module) -> list[ast.FunctionDef]:
    """Functions that launch a ``build.Kernel``: a call whose callee names
    a kernel or a local alias of one."""
    kernels = _kernel_names(tree)
    if not kernels:
        return []
    out = []
    for fn in _functions(tree):
        aliases = _local_aliases(fn, kernels)
        if any(_names_in(call.func) & aliases for call in _calls_in(fn)):
            out.append(fn)
    return out


def _rule_eager_compute(tree: ast.Module, path: str) -> list[LintViolation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and _is_library_conv(_dotted(node)):
            out.append(LintViolation(
                path, node.lineno, "eager-compute-in-kernel",
                f"{_dotted(node)}: a library convolution bypasses the "
                f"plan-driven im2col kernels"))
        elif isinstance(node, ast.ImportFrom) and node.module \
                and _is_library_conv(f"{node.module}.conv"):
            for alias in node.names:
                if alias.name.startswith("conv"):
                    out.append(LintViolation(
                        path, node.lineno, "eager-compute-in-kernel",
                        f"{node.module}.{alias.name}: a library convolution "
                        f"bypasses the plan-driven im2col kernels"))
    for fn in _launchers(tree):
        for node in ast.walk(fn):
            what = None
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                what = "@"
            elif isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted.rsplit(".", 1)[-1] in _LIBRARY_COMPUTE:
                    what = dotted
            if what:
                out.append(LintViolation(
                    path, node.lineno, "eager-compute-in-kernel",
                    f"{fn.name}: {what} inside a function that launches a "
                    f"kernel (the kernel computes it; library compute "
                    f"belongs in the plain twin)"))
    return out


def _autograd_functions(tree: ast.Module) -> set[str]:
    return {node.name for node in tree.body
            if isinstance(node, ast.ClassDef)
            and any(_dotted(b) in ("Function", "autograd.Function",
                                   "torch.autograd.Function")
                    for b in node.bases)}


def _rule_unjitted_custom_vjp(tree: ast.Module,
                              path: str) -> list[LintViolation]:
    cores = _autograd_functions(tree)
    if not cores:
        return []
    out = []
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or node.name.startswith("_"):
            continue
        used = _names_in(node) & cores
        if not used:
            continue
        applied, direct = set(), set()
        for call in _calls_in(node):
            f = call.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                    and f.value.id in cores:
                if f.attr == "apply":
                    applied.add(f.value.id)
                elif f.attr in ("forward", "backward"):
                    direct.add(f"{f.value.id}.{f.attr}")
        if direct or used - applied:
            out.append(LintViolation(
                path, node.lineno, "unjitted-custom-vjp-wrapper",
                f"{node.name} calls autograd Function(s) {sorted(used)} "
                f"without .apply ({sorted(direct) or 'no apply'}) -- the "
                f"kernel runs with no autograd node and the gradient is "
                f"lost"))
    return out


def _rule_unfaulted_wrapper(tree: ast.Module,
                            path: str) -> list[LintViolation]:
    kernel_aliases: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("repro_torch.kernels"):
            for alias in node.names:
                bound = alias.asname or alias.name
                if bound.startswith("_"):
                    kernel_aliases.add(bound)
    out = []
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or node.name.startswith("_"):
            continue
        if not (_names_in(node) & kernel_aliases):
            continue                      # planning helper, no executor
        faulted = any(
            _dotted(call.func).rsplit(".", 1)[-1] == "corrupt_array"
            for call in _calls_in(node))
        if not faulted:
            out.append(LintViolation(
                path, node.lineno, "unfaulted-wrapper",
                f"{node.name} invokes kernel(s) "
                f"{sorted(_names_in(node) & kernel_aliases)} without a "
                f"faults.corrupt_array site -- the chaos suite cannot "
                f"reach this executor"))
    return out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<memory>", *,
                roles: frozenset[str] | set[str] = _ALL_ROLES
                ) -> list[LintViolation]:
    """Lint one module's source.  ``roles`` scopes the location-specific
    rules: ``"kernels"`` applies the kernel-module rules, ``"ops"`` the
    fault-site rule; the cache and PlanError rules always run."""
    tree = ast.parse(source, filename=path)
    out = _rule_unbounded_cache(tree, path)
    out += _rule_nameless_plan_error(tree, path)
    if "kernels" in roles:
        out += _rule_eager_compute(tree, path)
        out += _rule_unjitted_custom_vjp(tree, path)
    if "ops" in roles:
        out += _rule_unfaulted_wrapper(tree, path)
    return sorted(out, key=lambda v: (v.path, v.line))


def _roles_for(path: str) -> frozenset[str]:
    norm = path.replace(os.sep, "/")
    roles = set()
    if "/kernels/" in norm:
        roles.add("kernels")
    if norm.endswith("kernels/ops.py"):
        roles.add("ops")
    return frozenset(roles)


def lint_paths(paths: Sequence[str]) -> list[LintViolation]:
    out: list[LintViolation] = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            out += lint_source(fh.read(), path, roles=_roles_for(path))
    return out


def lint_repo(root: str) -> list[LintViolation]:
    """Lint every ``.py`` module under ``root`` (``src/repro_torch``)."""
    paths = []
    for dirpath, _dirs, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".py"):
                paths.append(os.path.join(dirpath, name))
    return lint_paths(sorted(paths))
