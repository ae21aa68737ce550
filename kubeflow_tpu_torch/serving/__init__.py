"""Model serving: LM and classifier exports behind the V1 HTTP server."""
