"""CSR SpMV over a block-padded ELL layout (the substrate of matpower and
tanh+spmv) on a CUDA kernel: ``spmv_from_csr``, ``csr_spmv`` and
``csr_to_ell`` (``ops.py``); the plain torch version in ``ref.py``."""
