"""Hand-written CUDA kernels (``csrc/``) and their builder (``_build``).

The wrappers that launch them live beside their plain twins:
``ops/fused_tail.py`` and ``ops/compact.py``.
"""
