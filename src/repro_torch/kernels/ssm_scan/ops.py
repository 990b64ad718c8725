"""Public wrappers of the selective-scan kernel (K8).

``ssm_scan_batched`` is the reference's batched entry (its ``ops.py``
vmaps the per-sample kernel over the batch); here the kernel takes the
batch itself, one launch for all rows. The model calls
``selective_scan``, which also carries the state in and out.
"""

from repro_torch.kernels.ssm_scan.kernel import selective_scan, ssm_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref, ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_ref", "ssm_scan_batched", "selective_scan",
           "selective_scan_ref"]


def ssm_scan_batched(xi, dt, bmat, cmat, a_neg, *, chunk=128, block_d=512):
    """xi/dt ``(B, S, di)``; bmat/cmat ``(B, S, n)``; a_neg ``(di, n)`` →
    y ``(B, S, di)``, from a zero state. ``chunk`` and ``block_d`` are
    the reference's and change nothing."""
    if chunk < 1 or block_d < 1:
        raise ValueError(f"ssm_scan_batched: chunk and block_d must be "
                         f"positive, got {chunk}, {block_d}")
    y, _ = selective_scan(xi, dt, bmat, cmat, a_neg)
    return y
