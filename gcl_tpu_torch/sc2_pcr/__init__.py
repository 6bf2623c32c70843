"""The standalone SC2-PCR benchmarks over precomputed descriptors
(port of scripts/SC2_PCR/): ``python -m gcl_tpu_torch.sc2_pcr.test_kitti``
and its 3DMatch / 3DLoMatch shims, their loaders and utilities."""
