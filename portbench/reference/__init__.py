"""The plain reference of the benchmark's models: float32 PyTorch written
from the architectures' equations, one layer at a time.  It imports
nothing of the program and takes nothing the program made: the weights
and inputs come from the benchmark, and every cache and state is worked
out again here."""
