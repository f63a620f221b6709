"""PyTorch port of `bnn_priors_tpu` for NVIDIA Hopper GPUs.

The JAX package `bnn_priors_tpu` is the reference; this package mirrors its
module layout and never imports JAX or that package. Entry points run on the
card (`device="cuda"`) unless the caller asks for the CPU.
"""
