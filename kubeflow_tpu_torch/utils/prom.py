"""Prometheus exposition-format 0.0.4 emission — the port's copy of the
rendering half of ``kubeflow_tpu/utils/prom.py`` (what the model
server's ``/metrics`` reaches): scalars, labelled samples, and histograms
with ``_bucket``/``le``, ``_sum`` and ``_count`` series. The reference's
parser and validator are not copied; nothing in the port reads
exposition text.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple, Union

PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def _esc_label(v: str) -> str:
    """Exposition-format label-value escaping: backslash, quote,
    newline. A raw quote or newline in a label (e.g. a model name from
    user manifest metadata) would fail the whole scrape."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _esc_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


class HistogramValue:
    """Rendered form of one histogram sample: cumulative ``buckets``
    [(upper_bound, cumulative_count)] (the last bound is +Inf), plus
    the running ``sum`` and total ``count``."""

    __slots__ = ("buckets", "sum", "count")

    def __init__(self, buckets: List[Tuple[float, int]],
                 sum_: float, count: int):
        self.buckets = buckets
        self.sum = sum_
        self.count = count


def fmt_le(bound: float) -> str:
    """Bucket upper bound as Prometheus spells it (``le`` label)."""
    if math.isinf(bound):
        return "+Inf"
    return f"{bound:g}"


# value: a bare number, a HistogramValue, or a list of (labels, one of
# those) pairs — see prom_text.
Scalar = Union[int, float]
Value = Union[Scalar, HistogramValue,
              List[Tuple[Dict[str, str], Union[Scalar, HistogramValue]]]]


def _label_str(labels: Dict[str, str]) -> str:
    return ",".join(f'{k}="{_esc_label(v)}"' for k, v in labels.items())


def _render_sample(lines: List[str], name: str, labels: Dict[str, str],
                   value: Union[Scalar, HistogramValue]) -> None:
    if isinstance(value, HistogramValue):
        for bound, cum in value.buckets:
            lab = _label_str({**labels, "le": fmt_le(bound)})
            lines.append(f"{name}_bucket{{{lab}}} {cum}")
        suffix = f"{{{_label_str(labels)}}}" if labels else ""
        lines.append(f"{name}_sum{suffix} {value.sum}")
        lines.append(f"{name}_count{suffix} {value.count}")
    elif labels:
        lines.append(f"{name}{{{_label_str(labels)}}} {value}")
    else:
        lines.append(f"{name} {value}")


def prom_text(metrics: List[Tuple[str, str, str, Value]]) -> str:
    """Render [(name, type, help, value)] to exposition text.

    ``value`` is a scalar, a HistogramValue, or a list of
    (labels, scalar-or-HistogramValue) pairs:
        ("kfx_resources", "gauge", "Stored resources by kind.",
         [({"kind": "JAXJob"}, 3)])
    """
    lines: List[str] = []
    for name, mtype, help_, value in metrics:
        lines.append(f"# HELP {name} {_esc_help(help_)}")
        lines.append(f"# TYPE {name} {mtype}")
        if isinstance(value, list):
            for labels, v in value:
                _render_sample(lines, name, labels, v)
        else:
            _render_sample(lines, name, {}, value)
    return "\n".join(lines) + "\n"
