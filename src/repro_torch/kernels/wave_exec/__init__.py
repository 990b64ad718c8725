"""Wave-execution backend for the fused executor (DESIGN.md §2):
consumes ``core/executor`` WavePlans and executes each segment of
batched steps as one launch of a CUDA gather→scatter kernel. Public
surface: ``run_plan``, ``run_sequential``, ``WaveExecResult``,
``resolve_device``."""

from repro_torch.kernels.wave_exec.ops import (  # noqa: F401
    WaveExecResult,
    resolve_device,
    run_plan,
    run_sequential,
)
