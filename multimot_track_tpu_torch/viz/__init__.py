"""Offline rendering of the tracking results."""
