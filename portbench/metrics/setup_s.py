"""setup_s (s): from the process's start to the window's: imports, the
kernels' build where it is not cached, the weights' draw and the warm-up
(a training cell's first steps, which the check reads)."""


def read(rec):
    return rec["setup_s"]
