"""Directed edges scored per second: |E| x whole-graph calls completed in
the window / the window's seconds (each call's transfer and host merge
included)."""


def read(rec):
    if rec.kind != "whole_graph":
        return None
    done = sum(c["ok"] for c in rec.calls)
    return rec.edges * done / rec.seconds if done else None
