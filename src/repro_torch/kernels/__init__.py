"""Hand-written Hopper kernels of the port and their plain versions.

- :mod:`.ops` — numpy ELL packing and the dispatch by tensor device;
- :mod:`.ell_spmm`, :mod:`.cache_gather` — the CUDA kernel wrappers, each
  with a plain integer launch counter (``ell_spmm.ell_spmm.launches``,
  ``ell_spmm.ell_spmm_chunked.launches``, ``ell_spmm.ell_spmm_dh.launches``,
  ``ell_spmm.ell_spmm_dvals.launches``,
  ``cache_gather.gather_rows.launches``), and ``ell_spmm.EllSpmmFn``, the
  differentiable ELL product;
- :mod:`.ref` — the plain PyTorch versions;
- :mod:`.build` — ``nvcc`` build and ``ctypes`` loading of ``csrc/``.
"""
