"""The port's copy of the paper's core: LoopIR and its sequential
oracle, the DAE/CR/monotonicity front-end, AGU trace compilation, and
the WavePlan executor (start at ``repro_torch.core.executor.execute``)."""
