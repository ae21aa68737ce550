"""engine.step_ms: the summed durations of the engine's ``engine.chunk``
spans that started in the window, over the decode steps they ran, in
ms."""

NAME = "engine.step_ms"


def read(rec):
    serve = rec.get("serve")
    chunks = serve.get("chunks") if serve else None
    if not chunks:
        return None
    return 1e3 * sum(c["dur"] for c in chunks) / sum(
        c["steps"] for c in chunks)
