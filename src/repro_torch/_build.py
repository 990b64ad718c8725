"""Build the package's CUDA kernels from source, at first use.

Each kernel is one ``.cu`` file under ``csrc/`` with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).
It is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
a shared library under ``build/repro_torch/`` at the repository root,
named by a hash of the source and the flags, and loaded with
``ctypes``. A changed source therefore rebuilds by itself, and an
unchanged one is compiled once per checkout.

A failed build raises ``BuildError`` with the compiler's output;
nothing falls back to a plain version. ``build_all`` compiles every
source at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
REPO_ROOT = PKG_DIR.parent.parent
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

# every CUDA source of the package, by kernel name (path relative to
# the package)
SOURCES = {
    "wave_exec": "kernels/wave_exec/csrc/wave_exec.cu",
    "du_hazard": "kernels/du_hazard/csrc/du_hazard.cu",
    "fused_stream": "kernels/fused_stream/csrc/fused_stream.cu",
    "csr_spmv": "kernels/csr_spmv/csrc/csr_spmv.cu",
    "histogram": "kernels/histogram/csrc/histogram.cu",
    "attention": "kernels/attention/csrc/attention.cu",
    "ssm_scan": "kernels/ssm_scan/csrc/ssm_scan.cu",
    "moe_group_mm": "kernels/moe_group_mm/csrc/moe_group_mm.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise BuildError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives once built."""
    src = (PKG_DIR / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(name: str) -> float:
    """Compile kernel ``name`` unless its library is built already.
    Returns the seconds ``nvcc`` took (0.0 when nothing was built) and
    writes the compiler's log beside the library."""
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(PKG_DIR / SOURCES[name])]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True, check=False)
    took = time.perf_counter() - t0
    out.with_suffix(".log").write_text(p.stdout)
    if p.returncode != 0:
        os.unlink(tmp)
        raise BuildError(
            f"nvcc exit {p.returncode} building {name}:\n{p.stdout}"
        )
    os.replace(tmp, out)
    return took


def build_all() -> dict[str, float]:
    """Compile every kernel of ``SOURCES`` not built yet, each ``nvcc``
    started at once in its own process, and wait for all. Returns the
    seconds each took (0.0 where nothing was built); raises
    ``BuildError`` naming every kernel that failed, after all ended."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        jobs = {name: pool.submit(build, name) for name in SOURCES}
    failed = [str(f.exception()) for f in jobs.values() if f.exception()]
    if failed:
        raise BuildError("\n".join(failed))
    return {name: f.result() for name, f in jobs.items()}


# the seconds ``nvcc`` took for each kernel that ``load`` built in this
# process
BUILD_SECONDS: dict[str, float] = {}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed; a
    build's seconds go to ``BUILD_SECONDS``."""
    took = build(name)
    if took:
        BUILD_SECONDS[name] = took
    return ctypes.CDLL(str(library_path(name)))
