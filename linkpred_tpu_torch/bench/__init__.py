"""Synthetic graphs, the experiment harness, the log post-processor, the
bench row (``run``), the sweep runner and the reference suite's manifest."""
