"""Frozen copies of the scene generators the cells render (numpy only)."""
