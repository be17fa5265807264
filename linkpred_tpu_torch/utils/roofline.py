"""Memory roofline of a scoring pass (counterpart of
``linkpred_tpu/utils/roofline.py``): how far is a measured pass from the
card's memory rate?

A scoring pass is priced in MINIMUM device-memory bytes (every stream read
once, every intermediate written and read once, the sort at its theoretical
one read and one write), and the achieved GB/s on that model is set against
the card's peak.  The model is a LOWER bound on the traffic (the tile sort
makes several passes), so ``frac_of_peak`` is an upper bound on how close
the engine could be to the memory rate.  The byte model is the JAX
package's, unchanged, so the two packages price the same work with the same
number.

Per-slot byte model (packed stream, deg16, key64, fused tail, pack select):

  stream window reads      slot_w + slot_u + slot_udeg        12 B
  key64 build write        u64 key                             8 B
  tile sort (min 1r+1w)    (key 8 + payload 4) x 2            24 B
  flags/hi/lo pass         read key64 8, write 4+4+4          20 B
  fused tail kernel        read 4+4+4+4, write 4M+4+4         16+4M B
  selection (pack path)    read skey 4M, pack write 9/RATIO,
                           packed sort ~2x9/RATIO             ~4M+3.4 B

(M = number of metrics; weighted metrics add a 4 B f32 weight through the
sort: +4 stream read, +8 sort, +4 kernel read.)  The unfused and blocked
variants are priced too, as in the JAX package; the port always runs the
fused tail (K1) and the pack-capable selection (K2).
"""
from __future__ import annotations

import re
from typing import Optional

import torch

__all__ = ["device_peak_gbps", "packed_pass_min_bytes", "roofline_report"]

# Peak memory bandwidth per card (GB/s; NVIDIA's public data sheets), by
# the name torch.cuda.get_device_name gives.
_PEAKS = [
    (re.compile(r"H100.*NVL", re.I), 3900.0),            # H100 NVL
    (re.compile(r"H100.*PCIe", re.I), 2000.0),           # H100 PCIe
    (re.compile(r"H100.*(SXM|80GB HBM3)", re.I), 3350.0),  # H100 SXM
]


def device_peak_gbps(device=None) -> Optional[float]:
    """Peak memory GB/s of ``device`` (default: the first CUDA card if
    there is one); None for the CPU or a card not in the table."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    try:
        kind = torch.cuda.get_device_name(device)
    except (AssertionError, RuntimeError):    # torch built without CUDA
        return None
    for pat, peak in _PEAKS:
        if pat.search(kind):
            return peak
    return None


def packed_pass_min_bytes(total_slots: int, num_metrics: int = 1,
                          weighted: int = 0, key64: bool = True,
                          deg16: bool = True, fused: bool = True,
                          sel_pack: bool = True) -> int:
    """Minimum device-memory bytes for one packed-stream scoring pass
    (model above)."""
    m = num_metrics
    b = 12.0                                    # stream window reads
    if not deg16:
        b += 4                                  # separate wdeg stream
    b += 4 * weighted                           # per-slot f32 weights read
    b += 8 if key64 else 4                      # key build write
    payload = (4 if deg16 else 8) + 4 * weighted
    b += 2 * ((8 if key64 else 8) + payload)    # sort: one read + one write
    #   (u32 mode sorts (key4 + upay4) + payload — same 8 B of keys)
    if fused:
        b += (8 if key64 else 8) + 12           # flags pass r/w
        b += 16 + 4 * weighted + 4 * m + 8      # kernel read + skey/ku/kw
    else:
        b += 24 + 4 * m + 8                     # unfused tail intermediates
    if sel_pack:
        b += 4 * m + (9.0 / 8) * m + 2 * (9.0 / 8) * m   # pack + small sort
    else:
        b += 2 * 8 * 1.7 * m                    # blocked sorts, ~1.7 levels
    return int(b * total_slots)


def roofline_report(min_bytes: int, device_ms: float,
                    peak_gbps: Optional[float] = None) -> dict:
    """Achieved GB/s on the minimum-byte model + fraction of the peak."""
    peak = peak_gbps if peak_gbps is not None else device_peak_gbps()
    gbps = min_bytes / max(device_ms, 1e-9) / 1e6
    out = {"hbm_model_bytes": int(min_bytes),
           "achieved_gbps_min_model": round(gbps, 1)}
    if peak:
        out["hbm_peak_gbps"] = peak
        out["frac_of_peak"] = round(gbps / peak, 4)
    return out
