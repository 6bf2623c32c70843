"""Frozen copy of the port's ResUNet models (plain versions only)."""
from .resunet import ResUNetFatBN, ResUNetFatBNEXP

MODELS = {"ResUNetFatBN": ResUNetFatBN, "ResUNetFatBNEXP": ResUNetFatBNEXP}
