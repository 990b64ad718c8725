"""PyTorch/CUDA port of the dynamic-loop-fusion system (``repro``).

The package mirrors the JAX package's layout — ``core/``,
``analysis/``, ``kernels/``, ``configs/``, ``models/``, ``launch/`` — so each module's counterpart sits at the
same relative path. It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``: host logic that is numpy in the reference (the
AGU/CU compiler front-end, the WavePlan builder) is a copy of it here,
and every Pallas kernel on a ported path is a CUDA kernel written by
hand for Hopper (``sm_90a``), built from ``csrc/`` at first use by
``repro_torch._build``.

Ported so far: the wave executor's main path,
``core.executor.execute(program, arrays, params, backend="torch")``,
from LoopIR to final arrays, with the wave-step kernel
(``kernels/wave_exec``); the DU primitives on the hazard frontier and
forwarding kernels (``kernels/du_hazard``, ``kernels/fused_stream``)
with the WavePlan cross-checks built on them (``crosschecks``); the
cycle simulator, ``core.simulator.simulate`` (numpy on the host, as in
the reference); the speculative AGU (``core.speculate``) and cross-PE
FIFO streaming on both entry points; and the substrate ops on the ELL
SpMV and histogram kernels (``kernels/csr_spmv``,
``kernels/histogram``); and the LM serving path for GQA decoders
(``configs``, ``models``, ``launch.serve``) on the flash and decode
attention kernels (``kernels/attention``), extended to mixture-of-experts
decoders, whose dropless path runs the grouped matmul kernel
(``kernels/moe_group_mm``), and to Mamba-1 stacks, whose prefill runs the
selective-scan kernel (``kernels/ssm_scan``); and the HLS tools on the
host: the linter (``analysis.lint``), the DSE sweep service and its
calibration (``dse``), and the sweep summaries (``launch.analysis``).
Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, as the tests do.
"""
