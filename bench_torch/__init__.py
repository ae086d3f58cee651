"""The benchmark of rails_tpu_torch on one CUDA card (see README.md)."""
