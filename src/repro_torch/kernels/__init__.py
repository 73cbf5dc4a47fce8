"""Hand-written Hopper kernels of the port and their plain versions.

- :mod:`.ops` — numpy ELL and CSR packing, the differentiable ELL and
  hybrid products (``ops.EllSpmmFn``, ``ops.HybridSpmmFn``) and the
  dispatch by tensor device;
- :mod:`.ell_spmm`, :mod:`.csr_spmm`, :mod:`.cache_gather` — the CUDA
  kernel wrappers, each with a plain integer launch counter
  (``ell_spmm.ell_spmm.launches``, ``ell_spmm.ell_spmm_chunked.launches``,
  ``ell_spmm.ell_spmm_dvals.launches``, ``csr_spmm.csr_spmm.launches``
  (``d_h``), ``csr_spmm.csr_spmm_accumulate.launches`` (the hybrid tail's
  forward), ``cache_gather.gather_rows.launches``);
- :mod:`.ref` — the plain PyTorch versions;
- :mod:`.build` — ``nvcc`` build and ``ctypes`` loading of ``csrc/``.
"""
