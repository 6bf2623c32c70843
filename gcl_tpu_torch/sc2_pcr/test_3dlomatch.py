"""The standalone SC2-PCR 3DLoMatch benchmark (port of
scripts/SC2_PCR/test_3DLoMatch.py): test_kitti's runner with
config_3DLoMatch.json.

    python -m gcl_tpu_torch.sc2_pcr.test_3dlomatch --data_root ROOT
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from . import test_3dmatch


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    return test_3dmatch.main(argv, "config_3DLoMatch.json")


if __name__ == "__main__":
    main()
