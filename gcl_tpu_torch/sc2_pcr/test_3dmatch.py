"""The standalone SC2-PCR 3DMatch benchmark (port of
scripts/SC2_PCR/test_3DMatch.py): test_kitti's runner with
config_3DMatch.json, unless --config_path names another.

    python -m gcl_tpu_torch.sc2_pcr.test_3dmatch --data_root ROOT
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence

from . import test_kitti


def main(argv: Optional[Sequence[str]] = None,
         config_name: str = "config_3DMatch.json") -> Dict[str, float]:
    argv = list(sys.argv[1:] if argv is None else argv)
    return test_kitti.main(
        ["--config_path", os.path.join(test_kitti.CONFIG_DIR, config_name)]
        + argv)


if __name__ == "__main__":
    main()
