"""PyTorch / CUDA port of ``svae_tpu`` for an NVIDIA H100.

The JAX package ``svae_tpu`` is the reference; this package mirrors its
module names. It imports PyTorch and NumPy and never JAX. The first slice
is the LDS-SVAE inference path: recognize (``nets.recognition``), the
packed E-step (``models.lds`` on ``ops.estep``, whose filter and sampler
are hand-written CUDA kernels in ``csrc/estep.cu``), decode
(``nets.decoders``) and the MC-ELBO value (``train.elbo``).
"""
