"""Kernel families: each a ``<family>.json`` of profiler-name patterns and
a ``<family>.py`` of the functions that count the operations and bytes of
the family's work from the reference's maps. ``peaks.json`` holds the
card's published peaks."""
from __future__ import annotations

import re
from typing import Dict

from ..spec import HERE, load_json


def peaks() -> Dict[str, float]:
    return load_json(HERE / "kernels" / "peaks.json")


def device_seconds(kernel_s: Dict[str, float], family: dict) -> float:
    """The device time of the kernels whose names match one of the
    family's patterns."""
    pats = [re.compile(p) for p in family["patterns"]]
    return sum(s for name, s in kernel_s.items()
               if any(p.search(name) for p in pats))
