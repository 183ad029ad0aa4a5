"""Hand-written CUDA kernels (sources under ``csrc/``) and their wrappers.

Twin of the JAX package's ``ops/pallas``.  Nothing here is built or loaded at
import time: a wrapper builds the shared library the first time it is called
on a CUDA tensor.
"""
