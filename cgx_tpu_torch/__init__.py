"""cgx_tpu_torch: the grammar extractor on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``cgx_tpu``, which stays the reference; module names
and layout follow it.  This package imports ``torch`` and never ``jax`` or
``cgx_tpu``.  Its main path (``pipeline.run_pipeline``, ``cli``) currently
extracts the block-derived rule families (ab, Xab, abX, XabX).
"""
