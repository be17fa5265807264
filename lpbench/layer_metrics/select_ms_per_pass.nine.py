"""Selection: device ms of the metrics' selections a scoring of the whole
plan.  Each span ``select.metric`` (one metric's selection: its arg-select
and the gathers of its pairs; ``predict/scoring.py``) has, while the
profiler runs, a copy on the card's timeline (``cat``
``gpu_user_annotation``) from its first kernel's start to its last one's
end; their lengths are summed over the traced slice and divided by the
scorings of the plan traced (counted from K1's launches).  None, with one
line on standard error, in a serving run, where the slice holds no such
span (a program without it), or where their count is not a whole number of
selections of each metric in each scoring."""
import sys

from lpbench.layer_metrics._passes import plan_scorings

WHO = "select_ms_per_pass.nine"
SPAN = "select.metric"


def read(rec):
    if rec.kind != "whole_graph":
        print(f"{WHO}: a serving run; not read", file=sys.stderr)
        return None
    durs = [float(e.get("dur", 0)) for e in rec.events or ()
            if e.get("cat") == "gpu_user_annotation"
            and e.get("name") == SPAN]
    if not durs:
        print(f"{WHO}: no {SPAN} span on the card's timeline in the slice; "
              f"not read", file=sys.stderr)
        return None
    scorings = plan_scorings(rec, WHO)
    if not scorings:
        return None
    per = scorings * rec.n_metrics
    if len(durs) % per:
        print(f"{WHO}: {len(durs)} {SPAN} spans, not a multiple of "
              f"{scorings} scorings x {rec.n_metrics} metrics; not read",
              file=sys.stderr)
        return None
    print(f"{WHO}: {len(durs)} {SPAN} spans over {scorings} scorings, "
          f"{len(durs) // per} selections a metric a scoring",
          file=sys.stderr)
    return sum(durs) / 1e3 / scorings
