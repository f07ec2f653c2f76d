"""Hand-written Hopper kernels, their plain PyTorch versions and the
``ops`` entry points.  Importing this package builds nothing: each kernel
is compiled at its first launch (``_build``)."""
from .allgather_gemm import allgather_gemm, streamed_gemm

__all__ = ["allgather_gemm", "streamed_gemm"]
