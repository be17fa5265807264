"""How many times the traced calls scored the whole plan, counted from
K1's launches: one scoring launches K1 once a non-empty tile of each of
the plan's passes.  None, with a word on standard error, where the
launches are not the same whole number of scorings in every call."""
import sys

from lpbench.trace import family_us


def plan_scorings(rec, who: str):
    if rec.kind != "whole_graph" or not rec.events or not rec.passes \
            or not rec.traced_calls:
        return None
    per = sum(p["tiles"] for p in rec.passes)
    _, launches = family_us(rec.events, r"tail_onepass")
    if not per or not launches:
        return None
    if launches % (per * rec.traced_calls):
        print(f"{who}: {launches} K1 launches traced over "
              f"{rec.traced_calls} calls, not a multiple of the plan's "
              f"{per} tiles a call; not read", file=sys.stderr)
        return None
    return launches // per
