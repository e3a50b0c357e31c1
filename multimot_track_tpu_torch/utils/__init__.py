"""Observability helpers."""
