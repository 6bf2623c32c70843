"""Losses of the port (GCL group-wise contrastive losses)."""
