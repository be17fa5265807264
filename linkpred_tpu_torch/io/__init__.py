"""Native host helpers."""
