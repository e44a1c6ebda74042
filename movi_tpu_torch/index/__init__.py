"""Copy of movi_tpu/index/ (host modules, no JAX)."""
