"""train_tokens_per_s: tokens of all whole steps finished in the window,
over the window's seconds (the window ends on the last step's sync)."""

NAME = "train_tokens_per_s"


def read(rec):
    train = rec.get("train")
    if not train:
        return None
    return train["tokens"] / rec["window_s"]
