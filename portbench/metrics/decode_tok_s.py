"""decode_tok_s (tokens/s): the batch times the decode steps completed in
the window, over the window's wall time. Every step feeds every row one
position, a prompt's or a generated token's."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["steps"] else None
