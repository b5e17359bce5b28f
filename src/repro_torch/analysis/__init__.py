"""Static contract checkers of the PyTorch/CUDA port (the counterpart of
``repro/analysis``).  Three checkers, each run on one CPU without a card:

* ``collective_check`` — records one forward of the MoE engine for every
  dispatch path x topology through a recording EP world
  (``launch.mesh.RecordingWorld``) and holds the collective inventory
  (kind, wire dtype, element count, rank groups) against the one the
  Eq. (7) ``DispatchPlan`` promises;
* ``launch_check`` — walks the kernel registry
  (``kernels.backend.KERNEL_REGISTRY``: every CUDA launch of K1-K8 at the
  shapes its paths run) and checks shared memory and threads against
  the sm_90 limits, grid bounds, the rows each block addresses, the tile
  tables against their segment tables, and unguarded overlapping writes;
* ``lint`` — an AST pass over the port and the root ``chip_*.py``
  scripts for its own rules (collectives only through ``EPWorld``, no
  ``jax`` or ``repro`` import, no kernel fallback, every C entry's return
  code checked).

``python -m repro_torch.analysis`` runs all three, prints a JSON report
and exits 1 on a violation; ``--fixture NAME`` runs a planted fault
(``repro_torch.analysis.fixtures``) and exits 1 when its check fires.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract breach: which checker, which rule, where, and what."""

    checker: str          # "collective" | "launch" | "lint"
    rule: str             # stable rule id, e.g. "collective-inventory"
    where: str            # scenario / kernel layout / file:line
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """The checkers' results, serialized as the JSON report."""

    violations: list[Violation] = dataclasses.field(default_factory=list)
    checked: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    def extend(self, checker: str, items: list[Violation],
               covered: list[str]) -> None:
        self.violations.extend(items)
        self.checked.setdefault(checker, []).extend(covered)

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "violations": [v.to_dict() for v in self.violations],
            "checked": self.checked,
        }
