"""repro_torch: the Stripe (Nested Polyhedral Model) tensor compiler and its
serving engine, ported to PyTorch with hand-written CUDA kernels for the
NVIDIA H100.  The JAX package ``repro`` is the reference it is held
against; this package imports nothing of it.  See README.md."""
