"""Train loops (single device in this slice)."""
