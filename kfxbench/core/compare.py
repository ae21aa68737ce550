"""The comparison that decides ``correct``: the numbers read from the
program's outputs against the reference's, each against its limit.

Training (``loss_gap``, ``grad_gap``, ``change_gap``): each step's loss as
a relative gap; for every leaf, the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf, worst leaf taken. The gradient is the first step's,
as the optimizer gets it (after the clip); the change is of the
parameters over the checked steps, leaving out leaves whose first raw
reference gradient is under a thousandth of the median leaf's (round-off
alone moves them under Adam). Leaves below the median leaf, such as the
norm scales, weigh little against the median's norm, so
``grad_gap_small`` and ``change_gap_small`` take the worst of the moved
ones among them against its own norm.

Serving (``logit_gap``): the widest gap by which a served token's
reference logit lies below the reference's best at its position.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional

MOVED_SHARE = 1e-3


def loss_gap(program: List[float], reference: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             names: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's relative gap of norms."""
    names = list(reference if names is None else names)
    med = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], med)
               if math.isfinite(program[n]) else math.inf for n in names)


def own_gap(program: Dict[str, float], reference: Dict[str, float],
            names: Iterable[str]) -> float:
    """The worst relative gap of norms of ``names``, each leaf against its
    own norm."""
    return max((abs(program[n] - reference[n]) / reference[n]
                if math.isfinite(program[n]) else math.inf for n in names),
               default=0.0)


def below_median(reference: Dict[str, float], names: Iterable[str]
                 ) -> List[str]:
    names = list(names)
    med = statistics.median(reference[n] for n in names)
    return [n for n in names if reference[n] < med]


def moved(raw_reference_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(raw_reference_grads.values())
    return [n for n, g in raw_reference_grads.items()
            if g >= MOVED_SHARE * med]


def train_numbers(program: dict, reference: dict) -> Dict[str, float]:
    """The training numbers from the program's readings (losses,
    grad_norms, change_norms) and ``reference.train``'s result."""
    rg, rc = reference["grad_norms"], reference["change_norms"]
    pg, pc = program["grad_norms"], program["change_norms"]
    mv = moved(reference["raw_grad_norms"])
    small_grads = [n for n in below_median(rg, rg) if n in set(mv)]
    return {"loss_gap": loss_gap(program["losses"], reference["losses"]),
            "grad_gap": norm_gap(pg, rg), "change_gap": norm_gap(pc, rc, mv),
            "grad_gap_small": own_gap(pg, rg, small_grads),
            "change_gap_small": own_gap(pc, rc, below_median(rc, mv))}


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every number; a number without a
    limit gets limit 0, so it can only pass when exact."""
    return {n: {"value": v, "limit": float(limits.get(n, 0.0))}
            for n, v in numbers.items()}


def passed(checked: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())
