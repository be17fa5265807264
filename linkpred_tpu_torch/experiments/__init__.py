"""Counterparts of the JAX package's probes under ``experiments/``.

The kernel probes: ``pallas_tail`` (P1, K1's prototype), ``pallas_bitonic``
and ``pallas_bitonic2`` (P2 and P3, the bitonic network), ``radix_probe``
(P4, sequential dynamic-offset stores, beside the radix-sort feasibility
columns) and ``pallas_smoke`` (P5, the toolchain smoke).

The design probes, each a module of the JAX probe's name whose ``main``
runs on the card unless ``--device cpu`` is given (``_probe.py``):

* where a pass spends its time: ``profile_bench``, ``profile_tiles``,
  ``diag_scale``, ``diag_s21``, ``ab_split`` (``--deferred`` is
  ``ab_deferred.py``);
* the selection: ``ab_select``, ``ab_sel2``, ``ab_pack_sel``,
  ``diag_pack``;
* the tile's sort and gathers: ``ab_width2``, ``ab_batchsort``,
  ``ab_deg_gather``, ``ab_edge3``, ``ab_edge2``, ``ab_merge``, ``amort2``;
* the ranks and the campaign: ``mesh_overhead``, ``campaign_r5``.

``NOT_PORTED`` names the JAX probes with no counterpart, each with its
reason; ``FOLDED_INTO`` those that are a mode of another module.
Importing any of these modules runs nothing.
"""

# JAX probes of experiments/ with no counterpart here, and why.
NOT_PORTED = {
    "ab_stable": "it weighs the u32 packed key against a stable w-only key "
                 "with payloads; the port has one engine, the int64 "
                 "composite key (ROADMAP rules)",
    "ab_width": "it timed one sort a dispatch through the device relay; "
                "ab_width2.py replaced it for that reason "
                "(experiments/ab_width2.py:1-8), and its question is "
                "ab_width2's",
    "ab_cond": "it toggles LINKPRED_TILE_COND, the lax.cond skip of empty "
               "tiles; the port's tile loop never launches an empty tile "
               "(predict/scoring.py, _fill_buffer), so there is nothing to "
               "A/B",
}

# JAX probes whose counterpart is a mode of another module here.
FOLDED_INTO = {"ab_deferred": "ab_split"}
