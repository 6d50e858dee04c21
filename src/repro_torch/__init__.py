"""PyTorch/CUDA port of the THAPI reproduction (the JAX package ``repro`` is
the reference).  Mirrors ``repro``'s layout: ``core`` (tracing),
``models``, ``kernels`` (hand-written Hopper kernels + plain versions),
``serve`` and ``launch``."""
