"""Public csr_spmv wrappers: ``spmv_from_csr`` (CSR in, ``y = A @ x``
out), the ELL kernel ``csr_spmv``, its plain version ``csr_spmv_ref``,
and the layout pass ``csr_to_ell``."""

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.csr_spmv.kernel import csr_spmv
from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref, csr_to_ell

__all__ = ["csr_spmv", "csr_spmv_ref", "csr_to_ell", "spmv_from_csr"]


def spmv_from_csr(row_ptr, col_idx, values, x, *, block_r=128,
                  device="cuda"):
    """End-to-end ``y = A @ x`` from CSR inputs: the host lays ``A`` out
    as padded ELL (``csr_to_ell``), and ``csr_spmv`` multiplies on
    ``device``.

    ``row_ptr``, ``col_idx`` and ``values`` are array-likes; ``x`` is a
    numpy array or a tensor, moved to ``device``. ``"cuda"`` (the
    default) launches the kernel and raises ``RuntimeError`` without a
    card; ``"cpu"`` runs the plain version, for tests. The reference's
    ``interpret=`` and ``use_kernel=`` have no counterpart: the device
    decides, and nothing on the card runs the plain version. Returns a
    ``(n_rows,)`` tensor on ``device`` in ``x``'s dtype."""
    dev = resolve_device(device, "spmv_from_csr")
    n_rows = len(row_ptr) - 1
    cols, vals = csr_to_ell(
        np.asarray(row_ptr), np.asarray(col_idx), np.asarray(values),
        n_rows, block_r,
    )
    y = csr_spmv(torch.from_numpy(cols).to(dev),
                 torch.from_numpy(vals).to(dev),
                 torch.as_tensor(x, device=dev), block_r=block_r)
    return y[:n_rows]
