"""PyTorch and CUDA port of celestia_app_tpu's data-availability path.

The write side: ODS -> RS-extended EDS -> NMT row and column roots -> DAH
data root (da/eds.py, app/extend_block.py).  The read side: erasure repair
(da/repair.py), the NMT forests kept for proof serving and the DAS sampler
(serve/cache.py, serve/sampler.py), and batched proof verification
(serve/verify.py).  Hand-written CUDA kernels for the card (csrc/) and a
plain PyTorch version of each for tensors on the CPU.  The JAX package
celestia_app_tpu is the reference; this package imports nothing from it.
"""
