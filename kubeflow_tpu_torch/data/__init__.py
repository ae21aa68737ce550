"""Synthetic datasets (numpy only)."""
