"""Numeric helpers, device memory budgets, timing, the reference's log
grammar and the fault handler."""
