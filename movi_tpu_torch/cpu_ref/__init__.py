"""Copy of movi_tpu/cpu_ref/ (host modules, no JAX)."""
