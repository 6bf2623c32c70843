"""Frozen copy of the port's data modules (plain versions only)."""
