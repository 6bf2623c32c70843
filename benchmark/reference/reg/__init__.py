"""Frozen copy of the port's reg modules (plain versions only)."""
