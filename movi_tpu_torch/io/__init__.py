"""Copy of movi_tpu/io/ (host modules, no JAX)."""
