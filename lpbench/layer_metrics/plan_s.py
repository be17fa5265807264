"""Host plan: seconds of set-up's whole-graph ``build_plan`` (host
clock)."""


def read(rec):
    return rec.plan_s
