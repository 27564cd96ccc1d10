"""PyTorch + CUDA port of ractip_tpu for NVIDIA Hopper GPUs.

The JAX package ractip_tpu stays the reference; this package imports nothing
of it and never jax.  It keeps its own copies of the framework-free modules
it needs (constants, parameter tables, sequence encoding, energy evaluation,
FASTA I/O, shuffling, the corpus and its bundled sequences in seqdata/).
"""
