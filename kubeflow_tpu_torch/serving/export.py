"""Export format constants shared with ``kubeflow_tpu/serving/export.py``.

v1: the unversioned config. v2: adds ``format_version`` and the optional
``quant`` block. Loaders treat a missing field as v1, so every
pre-versioning export stays loadable.
"""

FORMAT_VERSION = 2
