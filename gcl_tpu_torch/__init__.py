"""gcl_tpu_torch — the PyTorch / CUDA port of gcl_tpu for NVIDIA Hopper.

This package serves GCL features and SC2-PCR registration on one H100:
voxelize -> stride levels + implicit kernel maps -> ResUNetFatBN (eval)
-> keypoint subsample -> SC2-PCR. The JAX package ``gcl_tpu`` is the
reference it is tested against; this package never imports it.

Subpackages mirror gcl_tpu's layout:
  core      keys, voxelizer, stride levels + query keys, sparse conv ops
  kernels   hand-written CUDA kernels (sources in csrc/), their ctypes
            loader, wrappers, plain PyTorch versions and launch counters
  models    every model gcl_tpu registers (the ResUNet2 family with its
            instance-norm and V2 variants, SimpleNets, heads, MLPs) as
            nn.Modules + the flax weight bridge
  parallel  data-parallel training, one process a card
  data      per-cloud voxelization, synthetic LiDAR scans
  reg       SE(3) helpers, weighted Kabsch, SC2-PCR
  infer     feature extractor + pair registration (the serving path)

Importing the package builds nothing: the kernel library is compiled by
nvcc at the first CUDA launch.
"""

__version__ = "0.1.0"
