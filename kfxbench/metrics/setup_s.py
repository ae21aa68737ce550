"""setup_s: process start to the window's opening (s)."""

NAME = "setup_s"


def read(rec):
    return rec["setup_s"]
