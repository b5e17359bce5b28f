"""The port's rule lint: an AST pass over ``src/repro_torch`` and the root
``chip_*.py`` scripts (the counterpart of ``repro/analysis/lint.py``).

* **raw-collective** — a ``torch.distributed`` collective
  (``all_to_all_single``, ``all_gather``, ``all_reduce``, ``broadcast``,
  ``send``, ``recv``, ...) outside ``launch/mesh.py``: every collective
  goes through ``EPWorld``, which is what lets the collective inventory
  wrap ``EPWorld``'s three methods and see all traffic;
* **foreign-import** — ``jax``, ``jaxlib``, ``ml_dtypes`` or the JAX
  package ``repro`` imported by a port module (the rule behind
  ``tests/test_torch_isolation.py``);
* **kernel-fallback** — in a kernel wrapper module (``kernels/*/ops.py``,
  or any module that binds a C entry with ``backend.bind``), an
  ``except`` handler that does not re-raise (it returns a plain version
  or carries on); or, anywhere in the package, a device chosen from
  ``torch.cuda.is_available()``: entry points run on the card unless the
  caller asks for the CPU;
* **unchecked-launch** — a call of a bound C entry (the result of a
  module function that calls ``backend.bind``) whose return code does
  not reach ``backend.check``.
"""

from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis import Violation

#: the one module allowed to call torch.distributed's collectives
MESH_SUFFIX = ("launch", "mesh.py")

COLLECTIVES = frozenset((
    "all_to_all_single", "all_to_all", "all_gather", "all_gather_object",
    "all_gather_into_tensor", "all_reduce", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "broadcast_object_list",
    "scatter", "gather", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "barrier", "monitored_barrier"))

FOREIGN = frozenset(("jax", "jaxlib", "ml_dtypes", "repro"))


def _attr_chain(node):
    """Dotted-name string for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _binds_entries(fn) -> bool:
    """Whether a function body calls ``backend.bind`` (or ``bind``)."""
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            chain = _attr_chain(sub.func)
            if chain and chain.split(".")[-1] == "bind":
                return True
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str, in_package: bool):
        self.relpath = relpath
        parts = pathlib.PurePath(relpath).parts
        self.is_mesh = tuple(parts[-2:]) == MESH_SUFFIX
        self.is_ops = (len(parts) >= 3 and parts[-1] == "ops.py"
                       and parts[-3] == "kernels")
        self.in_package = in_package
        self.violations: list[Violation] = []
        self.dist_names: set[str] = set()      # aliases of torch.distributed
        self.coll_names: set[str] = set()      # collectives imported by name
        self.getters: set[str] = set()         # functions that bind entries

    def _flag(self, rule: str, node, message: str) -> None:
        self.violations.append(Violation(
            "lint", rule, f"{self.relpath}:{node.lineno}", message))

    # -- imports: foreign-import, and the torch.distributed aliases ---------

    def visit_Import(self, node):
        for alias in node.names:
            root = alias.name.split(".")[0]
            if root in FOREIGN:
                self._flag("foreign-import", node,
                           f"import {alias.name}: the port imports no "
                           f"{root}")
            if alias.name == "torch.distributed":
                self.dist_names.add(alias.asname or "torch.distributed")
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if node.level == 0 and mod.split(".")[0] in FOREIGN:
            self._flag("foreign-import", node,
                       f"from {mod} import ...: the port imports no "
                       f"{mod.split('.')[0]}")
        if mod == "torch":
            for alias in node.names:
                if alias.name == "distributed":
                    self.dist_names.add(alias.asname or "distributed")
        if mod == "torch.distributed":
            for alias in node.names:
                if alias.name in COLLECTIVES:
                    self.coll_names.add(alias.asname or alias.name)
        self.generic_visit(node)

    # -- calls: raw-collective, foreign import_module, is_available ---------

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        if chain:
            head, _, tail = chain.rpartition(".")
            if not self.is_mesh and (
                    (tail in COLLECTIVES and (head in self.dist_names
                                              or head == "torch.distributed"))
                    or (not head and tail in self.coll_names)):
                self._flag("raw-collective", node,
                           f"{chain}() outside launch/mesh.py: go through "
                           f"EPWorld's collectives")
            if tail in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                root = str(node.args[0].value).split(".")[0]
                if root in FOREIGN:
                    self._flag("foreign-import", node,
                               f"{chain}({node.args[0].value!r}): the port "
                               f"imports no {root}")
            if self.in_package and chain.endswith("cuda.is_available"):
                self._flag("kernel-fallback", node,
                           f"{chain}() in the package: a device chosen by "
                           f"it falls back to the CPU; entry points run on "
                           f"the card unless the caller asks for the CPU")
        self.generic_visit(node)

    # -- kernel wrappers: kernel-fallback (except), unchecked-launch --------

    def visit_Try(self, node):
        if self.is_ops or self.getters:
            for h in node.handlers:
                if not any(isinstance(s, ast.Raise) for s in ast.walk(h)):
                    self._flag("kernel-fallback", h,
                               "an except handler in a kernel wrapper that "
                               "does not re-raise: a failed launch must "
                               "fail, not fall back to a plain version")
        self.generic_visit(node)

    visit_TryStar = visit_Try

    def visit_FunctionDef(self, node):
        if self.getters:
            self._check_launches(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _is_getter_call(self, node) -> bool:
        """``_entry()`` or ``_entries()[i]``."""
        if isinstance(node, ast.Subscript):
            node = node.value
        return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in self.getters)

    def _check_launches(self, fn):
        handles: set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and self._is_getter_call(sub.value):
                for tgt in sub.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            handles.add(n.id)
        checked: set[str] = set()
        checked_calls: set[int] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                chain = _attr_chain(sub.func) or ""
                if chain.split(".")[-1] == "check" and len(sub.args) >= 2:
                    arg = sub.args[1]
                    if isinstance(arg, ast.Name):
                        checked.add(arg.id)
                    elif isinstance(arg, ast.Call):
                        checked_calls.add(id(arg))
        results: dict[int, str] = {}
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        results[id(sub.value)] = tgt.id
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            is_entry = ((isinstance(f, ast.Name) and f.id in handles)
                        or self._is_getter_call(f))
            if not is_entry:
                continue
            if id(sub) in checked_calls or results.get(id(sub)) in checked:
                continue
            self._flag("unchecked-launch", sub,
                       f"a C entry called in '{fn.name}' whose return code "
                       f"does not reach backend.check")


def lint_source(source: str, path: str, relpath: str | None = None,
                in_package: bool = True) -> list[Violation]:
    tree = ast.parse(source, filename=path)
    linter = _Linter(relpath or path, in_package)
    # the entry getters must be known before function bodies are checked
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and _binds_entries(node):
            linter.getters.add(node.name)
    linter.visit(tree)
    return linter.violations


def run(root=None) -> tuple[list[Violation], list[str]]:
    """Lint every .py file of the package (fixtures excluded: they exist
    to break the rules) and the root ``chip_*.py`` scripts.  Returns
    ``(violations, covered_files)``."""
    pkg = pathlib.Path(__file__).resolve().parents[1]
    src = pkg.parent
    repo = src.parent if root is None else pathlib.Path(root)
    violations, covered = [], []
    files = [(p, True) for p in sorted(pkg.rglob("*.py"))
             if "fixtures" not in p.relative_to(pkg).parts]
    files += [(p, False) for p in sorted(repo.glob("chip_*.py"))]
    for path, in_package in files:
        rel = str(path.relative_to(src if in_package else repo))
        covered.append(rel)
        violations.extend(lint_source(path.read_text(), str(path), rel,
                                      in_package))
    return violations, covered
