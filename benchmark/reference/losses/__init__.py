"""Frozen copy of the port's losses modules (plain versions only)."""
