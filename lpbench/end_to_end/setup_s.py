"""Set-up: the program's import, the graph, the whole-graph plan where the
mix has one, the kernels' build where the checkout has none, and the
warm-up calls."""


def read(rec):
    return rec.setup_s
