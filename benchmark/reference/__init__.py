"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (voxelize, colocation groups, stride levels and conv maps,
the sparse U-Net, the losses, SC2-PCR, feature matching and RANSAC), with
every kernel replaced by its plain version. It imports nothing of the
port, of JAX or of the JAX package. ``kernels.build.product_precision``
runs it in a lower precision: the control of the comparison."""
