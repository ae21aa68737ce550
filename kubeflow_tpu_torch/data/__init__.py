"""Synthetic datasets (numpy; the image sets' device batches in torch)."""

from .synthetic import Dataset, get_dataset  # noqa: F401
