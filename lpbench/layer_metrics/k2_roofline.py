"""K2 (``compact.cu``): the least time its launches in the device slice
could take (the bytes of ``lpbench.roofline.k2_bytes`` over the card's
peak) over their device time (``pack_onepass`` with the memset before it,
and ``pack_fill``), in %.  Each scoring of the plan traced launches K2
once a metric for each selection that takes the pack: a pass's own, or
the merge of a segmented pass's winners (``merge_pack``); each launch
counts its bytes."""
import sys

from lpbench.layer_metrics._passes import plan_scorings
from lpbench.roofline import k2_bytes, peak_bytes_per_s
from lpbench.trace import family_us


def read(rec):
    peak = peak_bytes_per_s(rec.kind_of_card)
    scorings = plan_scorings(rec, "k2_roofline")
    packing = [(p["filled"], p["kk"]) for p in (rec.passes or ())
               if p["packs"]]
    packing += [(p["merge_pack"]["filled"], p["merge_pack"]["kk"])
                for p in (rec.passes or ()) if "merge_pack" in p]
    if not peak or not scorings:
        return None
    if not packing:
        print("k2_roofline: no selection of the plan takes the survivor "
              "pack (the plan line's pack off, no merge pack); not read",
              file=sys.stderr)
        return None
    us, launches = family_us(rec.events, r"pack_onepass", with_memset=True)
    fill_us, _ = family_us(rec.events, r"pack_fill")
    want = scorings * rec.n_metrics * len(packing)
    if launches != want:
        print(f"k2_roofline: {launches} launches traced, not the "
              f"{scorings} scorings' {want} ({rec.n_metrics} a selection); "
              f"not read", file=sys.stderr)
        return None
    nbytes = scorings * rec.n_metrics * sum(k2_bytes(f, kk)
                                            for f, kk in packing)
    return 100.0 * (nbytes / peak) / ((us + fill_us) / 1e6)
