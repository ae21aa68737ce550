"""engine.prefix_hit_pct: the change over the window of
``DecodeEngine.prefix_stats()``'s tokens_reused over its prompt_tokens,
in %."""

NAME = "engine.prefix_hit_pct"


def read(rec):
    serve = rec.get("serve")
    if not serve:
        return None
    before, after = serve["prefix"]
    prompt = after["prompt_tokens"] - before["prompt_tokens"]
    if prompt <= 0:
        return None
    return 100.0 * (after["tokens_reused"] - before["tokens_reused"]) / prompt
