"""PyTorch + CUDA port of ractip_tpu for NVIDIA Hopper GPUs.

The JAX package ractip_tpu stays the reference; this package imports only its
framework-free modules (constants, parameter tables, sequence encoding,
energy evaluation, FASTA I/O, shuffling, corpus paths) and never jax.
"""
