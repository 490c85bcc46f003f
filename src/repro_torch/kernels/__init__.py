"""Hand-written CUDA kernels for Hopper (``sm_90a``), each with its plain
PyTorch version beside it and a launch counter.

* ``contraction``     -- one Stripe fusion group per launch (prologue DAGs,
                         the contraction, the epilogue DAG); CUDA C++ in
                         ``csrc/contraction.cu``
* ``elementwise``     -- one Stripe map unit per launch (an unfused
                         activation, bias add or gate); ``csrc/elementwise.cu``
* ``windowed``        -- one halo / conv / masked-remainder unit per launch;
                         ``csrc/windowed.cu``
* ``stripe_matmul``   -- a one-block Tile matmul compiled by the pipeline
                         under the ``h100`` config, launched through
                         ``contraction``
* ``flash_attention`` -- GQA flash attention forward, causal or full;
                         ``csrc/flash_attention.cu``; block sizes from the
                         Stripe autotiler under ``h100``
* ``mlstm_chunk``     -- chunkwise gated linear attention (xLSTM's mLSTM);
                         ``csrc/gla.cu``
* ``ssd_chunk``       -- Mamba2's SSD scan, a wrapper over ``mlstm_chunk``
* ``moe_dispatch``    -- the MoE dispatch's positions in the experts'
                         capacity rows; ``csrc/moe_dispatch.cu``

``_build`` compiles the six sources (one ``nvcc`` each, started
together) at first use and binds them with ``ctypes``.
"""
