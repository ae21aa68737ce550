"""Worker runtime helpers (the port's copy of what it needs from
``kubeflow_tpu/runtime``)."""
