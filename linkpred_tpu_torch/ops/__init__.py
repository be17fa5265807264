"""Graph transforms, batch updates, segmented scans, top-k and the two
kernels' modules (``fused_tail``, ``compact``)."""
