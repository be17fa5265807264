"""Synthetic benchmark graphs."""
