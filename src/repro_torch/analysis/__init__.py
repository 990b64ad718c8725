"""Static analyses over LoopIR programs (DESIGN.md §12): the symbolic
dependence certifier ``analysis.deps``, which the wave executor calls
for its symbolic admission fast path and ``MonotonicHint`` checks."""
