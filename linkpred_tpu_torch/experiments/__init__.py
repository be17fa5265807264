"""Counterparts of the JAX package's kernel probes under ``experiments/``:
``pallas_tail`` (P1, K1's prototype) and ``pallas_smoke`` (P5, the toolchain
smoke).  Importing them runs nothing."""
