"""PyTorch/CUDA port of seaweedfs_tpu's erasure-coding path.

The volume EC path (write a volume, ``.ecx``, RS(10,4) encode, rebuild of
lost shards, decode back to ``.dat``, needle read-back) runs here on an
NVIDIA H100: the GF(2^8) transform the JAX package runs as a Pallas kernel
is the hand-written CUDA kernel in ``csrc/gf_apply.cu``. Module paths mirror
``seaweedfs_tpu``; on-disk files are byte-compatible with it. This package
imports neither ``jax`` nor ``seaweedfs_tpu``.
"""
