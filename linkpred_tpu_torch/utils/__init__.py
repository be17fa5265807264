"""Numeric helpers, device memory budgets and timing."""
