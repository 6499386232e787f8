"""Weighted-fair scheduling across priority classes (port of
flexflow_tpu/serving/tenancy/fairness.py; plain Python, as in the
reference).

Two mechanisms share one :class:`DeficitRoundRobin` core:

- **Admission** (cost = 1 per request): instead of strict global FIFO,
  the scheduler serves per-class FIFO queues in deficit round-robin
  order, so a gold:4 / bronze:1 config admits ~4 gold requests per
  bronze under contention while bronze still admits every round —
  starvation-free by construction (every backlogged class's deficit
  grows by its quantum each round, so it affords a serve within
  ``ceil(cost / quantum)`` rounds).
- **Token grants** (cost = the chunk unit, up to chunk_size): the chunk
  planner's per-iteration grants are DRR serves, so prefill
  bandwidth under a token budget divides by class weight instead of
  admission order.

The DRR state is deliberately tiny and inspectable (``deficit`` is a
public dict) because the tests assert its conservation invariant
directly: after any serve sequence, every class's deficit sits in
``[0, quantum + max_cost)`` and idle classes forfeit theirs.

``select`` is PURE (commit-on-success): admission may discover the
chosen class's head cannot take a slot right now, in which case nothing
must have been charged — the caller only ``charge``s after the admit
actually lands.
"""

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

_EPS = 1e-9


@dataclass(frozen=True)
class PriorityClass:
    """One tenant class: scheduling weight plus optional per-class SLO
    targets (0 = no target; the class still gets labelled latency
    windows, just no violation counting)."""

    name: str
    weight: float = 1.0
    slo_ttft_ms: float = 0.0
    slo_itl_ms: float = 0.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("priority class needs a name")
        if self.weight <= 0:
            raise ValueError(
                f"class {self.name!r}: weight must be > 0, "
                f"got {self.weight}"
            )
        if self.slo_ttft_ms < 0 or self.slo_itl_ms < 0:
            raise ValueError(
                f"class {self.name!r}: SLO targets must be >= 0"
            )


def parse_classes(spec: str) -> Dict[str, PriorityClass]:
    """Parse the ``--classes`` flag: ``name:weight[:ttft_ms[:itl_ms]]``
    entries, comma-separated — e.g. ``gold:4:200:50,bronze:1``. Config
    order is scheduling order (DRR visit order and the default class for
    requests that name none)."""
    classes: Dict[str, PriorityClass] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) > 4:
            raise ValueError(
                f"class entry {entry!r}: expected "
                "name:weight[:ttft_ms[:itl_ms]]"
            )
        name = parts[0].strip()
        if name in classes:
            raise ValueError(f"duplicate class {name!r}")
        try:
            weight = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            ttft = float(parts[2]) if len(parts) > 2 and parts[2] else 0.0
            itl = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
        except ValueError:
            raise ValueError(f"class entry {entry!r}: non-numeric field")
        classes[name] = PriorityClass(
            name=name, weight=weight, slo_ttft_ms=ttft, slo_itl_ms=itl
        )
    if not classes:
        raise ValueError(f"no classes in spec {spec!r}")
    return classes


class DeficitRoundRobin:
    """Deficit round-robin over named classes.

    Each *round* credits every backlogged class ``quantum = unit *
    weight``; a class is served while its deficit affords the head
    cost. Rather than looping rounds imperatively, :meth:`select`
    computes for each backlogged class how many whole rounds it needs
    before it can afford its head (``ceil((cost - deficit) /
    quantum)``) and serves the minimum — ties break by visit order from
    the cursor, so equal-entitlement decisions are deterministic and
    chaos schedules replay exactly. :meth:`charge` then commits that
    serve: the skipped rounds' quanta accrue to EVERY backlogged class
    (they were entitled to them), the served class pays its cost, and
    the cursor parks on it (classic DRR keeps serving a class while its
    deficit lasts)."""

    def __init__(self, weights: Mapping[str, float], unit: float = 1.0):
        if not weights:
            raise ValueError("DeficitRoundRobin needs at least one class")
        self._order = list(weights)
        self.weights = {n: float(w) for n, w in weights.items()}
        for n, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"class {n!r}: weight must be > 0, got {w}")
        if unit <= 0:
            raise ValueError(f"unit must be > 0, got {unit}")
        self.unit = float(unit)
        self.deficit: Dict[str, float] = {n: 0.0 for n in self._order}
        self._cursor = 0

    def quantum(self, name: str) -> float:
        return self.unit * self.weights[name]

    def _rounds(self, name: str, cost: float) -> int:
        """Whole rounds before `name` affords `cost` (0 = affords now)."""
        short = cost - self.deficit[name]
        if short <= _EPS:
            return 0
        q = self.quantum(name)
        return int(-(-(short - _EPS) // q))

    def select(
        self, costs: Mapping[str, float]
    ) -> Optional[Tuple[str, int]]:
        """PURE: the next DRR serve over the backlogged classes in
        ``costs`` ({class: its head's cost}) — returns (class, rounds
        the serve had to wait) or None when nothing is backlogged.
        State is untouched until :meth:`charge` commits."""
        best: Optional[Tuple[str, int]] = None
        n = len(self._order)
        for i in range(n):
            name = self._order[(self._cursor + i) % n]
            if name not in costs:
                continue
            r = self._rounds(name, float(costs[name]))
            if best is None or r < best[1]:
                best = (name, r)
        return best

    def charge(
        self,
        name: str,
        rounds: int,
        backlogged: Sequence[str],
        cost: float = 1.0,
    ) -> None:
        """Commit the serve :meth:`select` chose."""
        if rounds:
            for nm in self._order:
                if nm in backlogged:
                    self.deficit[nm] += rounds * self.quantum(nm)
        self.deficit[name] -= float(cost)
        self._cursor = self._order.index(name)

    def settle(self, backlogged: Sequence[str]) -> None:
        """Classic DRR bookkeeping between planning passes: a class with
        no backlog forfeits its carried deficit (credit must never
        accumulate while idle — that would let a silent class burst
        past its weight later)."""
        for nm in self._order:
            if nm not in backlogged:
                self.deficit[nm] = 0.0

    def check_invariants(self, max_cost: float = 1.0) -> None:
        """Deficit conservation: every class's deficit sits in
        ``(-eps, quantum + max_cost)`` — a serve only happens once
        affordable (floor) and rounds are minimal (ceiling)."""
        for nm in self._order:
            d = self.deficit[nm]
            hi = self.quantum(nm) + float(max_cost)
            if not (-_EPS <= d < hi + _EPS):
                raise AssertionError(
                    f"class {nm!r}: deficit {d} outside [0, {hi})"
                )
