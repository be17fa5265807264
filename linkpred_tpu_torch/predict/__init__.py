"""The link-prediction engine: metrics, plan, scoring, API.

The reference's names come from ``api``, ``metrics`` and ``plan`` on first
use (a module ``__getattr__``), so importing this package, or
``predict.metrics`` alone, imports neither ``api`` nor ``plan``:
``predict.metrics`` stays a leaf that ``ops/`` can import.
"""
import importlib

_WHERE = {
    "PredictOptions": "api", "PredictResult": "api", "predict_links": "api",
    "predict_links_multi": "api", "top_per_source": "api",
    "PlanCache": "api", "METRICS": "metrics", "TECHNIQUE_NAMES": "metrics",
    "get_metric": "metrics", "TilePlan": "plan", "build_plan": "plan",
}

__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_WHERE[name]}", __name__),
                    name)
    globals()[name] = value
    return value
