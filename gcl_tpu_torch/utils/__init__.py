"""utils subpackage of gcl_tpu_torch (mirrors gcl_tpu/utils)."""
