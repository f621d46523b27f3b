"""Operational tools: recall measurement."""
