"""Tile loop: device ms of the radix-sort kernels (``torch.sort``'s: the
tile sorts and the selection's) a scoring of the whole plan, over the
scorings traced (counted from K1's launches, so a call that scores its
plan twice counts two)."""
from lpbench.layer_metrics._passes import plan_scorings
from lpbench.trace import family_us


def read(rec):
    scorings = plan_scorings(rec, "sort_ms_per_pass.batch")
    if not scorings:
        return None
    us, launches = family_us(rec.events, r"(?i)radixsort")
    return us / 1e3 / scorings if launches else None
