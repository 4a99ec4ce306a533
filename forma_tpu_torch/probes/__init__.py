"""Measurement probes: the port's counterparts of the Pallas kernels of
the JAX package's TPU tools (`tools/*.py`), each a hand-written CUDA kernel
with its plain PyTorch version and an entry point that times it on the
card.

  texture_fold   K5: texture sampling inside a fold loop
                 (`tools/texture_fold_probe.py`, csrc/texture_probe.cu)
"""
