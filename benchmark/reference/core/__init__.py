"""Frozen copy of the port's core modules (plain versions only)."""
