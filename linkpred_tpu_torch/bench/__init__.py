"""Synthetic graphs, the experiment harness and the log post-processor."""
