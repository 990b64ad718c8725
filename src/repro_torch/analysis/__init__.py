"""Static analyses over LoopIR programs (DESIGN.md §12).

The port's copy of ``analysis/`` in the JAX package. Two layers on top
of the §3 CR algebra:

  * ``analysis.deps``  — the symbolic dependence certifier: per-hazard-
    pair verdicts (``never_conflict`` / ``min_distance`` / ``unknown``),
    the forced-pass certificate that lets ``hazards.build_plan(...,
    static_prune=True)`` drop pairs with bit-identical timing, per-op
    conflict-freedom certificates for the wave coarsener's symbolic
    admission fast path, and the runtime ``MonotonicHint`` sanitizer
    (``validate_hints=``),
  * ``analysis.lint``  — RPL0xx diagnostics over registered kernels or
    program files (``python -m repro_torch.analysis.lint``).
"""
