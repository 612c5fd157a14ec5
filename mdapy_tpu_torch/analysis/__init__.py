"""The structure analyses in float64 torch ops (the port of
``mdapy_tpu/analysis/``, the modules that compute through jax)."""
