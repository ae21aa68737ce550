"""Worker entry points."""
