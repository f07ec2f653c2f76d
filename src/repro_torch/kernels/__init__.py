"""Hand-written Hopper kernels, their plain PyTorch versions and the
``ops`` entry points.  Importing this package builds nothing: each kernel
is compiled at its first launch (``_build``)."""
