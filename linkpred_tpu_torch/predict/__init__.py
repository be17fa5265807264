"""The link-prediction engine: metrics, plan, scoring, API.

Kept empty so ``predict.metrics`` stays a leaf that ``ops/`` can import.
"""
