"""PyTorch + CUDA port of the CT-MCQ-VAE serving path.

Layout mirrors the JAX package (``ops/``, ``models/``, ``serving/``);
public functions keep its layouts (NHWC images, ``[B, S, N]``
sequences, ``adj[b, s, t]`` = edge s -> t). The hot ops run through
hand-written CUDA kernels (``csrc/``) built with ``nvcc`` at first use;
on CPU tensors each op runs its plain PyTorch version.
"""
