"""train_tok_s (tokens/s): the tokens of every training step completed in
the window, over the window's wall time; each step ends by reading its
metrics on the host."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["steps"] else None
