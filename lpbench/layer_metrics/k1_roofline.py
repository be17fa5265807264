"""K1 (``fused_tail.cu``): the least time its launches in the device slice
could take (the bytes of ``lpbench.roofline.k1_bytes`` over the card's
peak) over their device time (each ``tail_onepass`` launch and the memset
before it), in %.  A call may score its plan more than once (the API's
untimed warm-up pass); each scoring traced counts its bytes."""
from lpbench.layer_metrics._passes import plan_scorings
from lpbench.roofline import k1_bytes, peak_bytes_per_s
from lpbench.trace import family_us


def read(rec):
    peak = peak_bytes_per_s(rec.kind_of_card)
    scorings = plan_scorings(rec, "k1_roofline")
    if not peak or not scorings:
        return None
    us, _ = family_us(rec.events, r"tail_onepass", with_memset=True)
    nbytes = scorings * sum(
        k1_bytes(p["lanes"], wide_degrees=p["wide"],
                 n_weighted=rec.n_weighted, n_metrics=rec.n_metrics)
        for p in rec.passes)
    return 100.0 * (nbytes / peak) / (us / 1e6)
