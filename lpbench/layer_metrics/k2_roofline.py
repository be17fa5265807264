"""K2 (``compact.cu``): the least time its launches in the device slice
could take (the bytes of ``lpbench.roofline.k2_bytes`` over the card's
peak) over their device time (``pack_onepass`` with the memset before it,
and ``pack_fill``), in %.  Each scoring of the plan traced launches K2
once a pass whose selection takes the pack, and counts its bytes."""
import sys

from lpbench.layer_metrics._passes import plan_scorings
from lpbench.roofline import k2_bytes, peak_bytes_per_s
from lpbench.trace import family_us


def read(rec):
    peak = peak_bytes_per_s(rec.kind_of_card)
    scorings = plan_scorings(rec, "k2_roofline")
    packing = [p for p in (rec.passes or ()) if p["packs"]]
    if not peak or not scorings or not packing:
        return None
    us, launches = family_us(rec.events, r"pack_onepass", with_memset=True)
    fill_us, _ = family_us(rec.events, r"pack_fill")
    if launches != scorings * len(packing):
        print(f"k2_roofline: {launches} launches traced, not the "
              f"{scorings} scorings' {scorings * len(packing)}; not read",
              file=sys.stderr)
        return None
    nbytes = scorings * sum(k2_bytes(p["filled"], p["kk"]) for p in packing)
    return 100.0 * (nbytes / peak) / ((us + fill_us) / 1e6)
