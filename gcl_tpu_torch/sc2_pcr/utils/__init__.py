"""SC2-PCR's auxiliary utilities (port of scripts/SC2_PCR/utils/)."""
