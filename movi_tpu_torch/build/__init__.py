"""Copy of movi_tpu/build/ (host modules, no JAX)."""
