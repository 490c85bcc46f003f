"""Hand-written CUDA kernels for Hopper (``sm_90a``), each with its plain
PyTorch version beside it and a launch counter.

* ``contraction``   -- one Stripe fusion group per launch (the kernel of
                       the ``cuda`` backend); CUDA C++ in ``csrc/``
* ``stripe_matmul`` -- a one-block Tile matmul compiled by the pipeline
                       under the ``h100`` config, launched through
                       ``contraction``
"""
