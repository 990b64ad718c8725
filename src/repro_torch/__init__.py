"""PyTorch/CUDA port of the dynamic-loop-fusion system (``repro``).

The package mirrors the JAX package's layout — ``core/``,
``analysis/``, ``kernels/`` — so each module's counterpart sits at the
same relative path. It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``: host logic that is numpy in the reference (the
AGU/CU compiler front-end, the WavePlan builder) is a copy of it here,
and every Pallas kernel on a ported path is a CUDA kernel written by
hand for Hopper (``sm_90a``), built from ``csrc/`` at first use by
``repro_torch._build``.

Ported so far: the wave executor's main path,
``core.executor.execute(program, arrays, params, backend="torch")``,
from LoopIR to final arrays, with the wave-step kernel
(``kernels/wave_exec``). Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, as the tests do.
"""
