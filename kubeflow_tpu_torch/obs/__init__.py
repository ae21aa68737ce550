"""Observability: the metrics registry and request spans."""
