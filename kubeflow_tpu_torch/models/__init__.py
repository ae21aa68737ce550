"""Model zoo (the dense TransformerLM in this slice)."""
