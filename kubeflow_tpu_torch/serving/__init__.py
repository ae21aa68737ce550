"""Model serving (one-shot LM generation behind the V1 HTTP server)."""
