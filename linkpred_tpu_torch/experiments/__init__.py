"""Counterparts of the JAX package's kernel probes under ``experiments/``:
``pallas_tail`` (P1, K1's prototype), ``pallas_bitonic`` and
``pallas_bitonic2`` (P2 and P3, the bitonic network), ``radix_probe`` (P4,
sequential dynamic-offset stores, beside the radix-sort feasibility
columns) and ``pallas_smoke`` (P5, the toolchain smoke).  Importing them
runs nothing."""
