"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions
(``ref``) and the dispatch wrappers the models call (``ops``)."""
