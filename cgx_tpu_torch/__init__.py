"""cgx_tpu_torch: the grammar extractor on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``cgx_tpu``, which stays the reference; module names
and layout follow it.  This package imports ``torch`` and never ``jax`` or
``cgx_tpu``.  Its entry points (``pipeline.run_pipeline`` and
``run_pipeline_overlap``, ``cli``, ``serve``, the persisted index in
``preproc.index_io`` and the numpy ``oracle``) write every rule family.
"""
