"""kernel_build_s (s): the seconds ``nvcc`` took for the port's kernels
that the run built (``repro_torch._build.BUILD_SECONDS``, which
``_build.load`` keeps); 0 where every kernel the run loaded was built
already, so it reads the checkout's build cache as much as the program.
None for a program that keeps no such tally."""

import importlib


def read(rec):
    try:
        build = importlib.import_module("repro_torch._build")
    except ImportError:
        return None
    took = getattr(build, "BUILD_SECONDS", None)
    return None if took is None else sum(took.values())
