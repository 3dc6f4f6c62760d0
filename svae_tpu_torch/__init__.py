"""PyTorch / CUDA port of ``svae_tpu`` for an NVIDIA H100.

The JAX package ``svae_tpu`` is the reference; this package mirrors its
module names. It imports PyTorch and NumPy and never JAX. It holds the
GMM-SVAE (``models.gmm``, a block mean-field of torch ops over the
``expfam.gaussian`` and ``expfam.categorical`` families), the LDS-SVAE
inference and training paths (``models.lds`` on the packed E-step of
``ops.estep`` or, for ragged batches, the per-sequence-pairs E-step of
``ops.bpairs``) and SLDS-SVAE training (``models.slds``, a structured
mean-field alternating ``ops.bpairs`` with the HMM forward-backward of
``ops.hmm_fb``), the forecast and state-sampling APIs (``lds.predict``,
``slds.sample_states``, ``slds.predict``, ``ops.hmm.hmm_sample``) and
the MAP decode (``slds.most_likely_states``), with the recognition nets
and decoders (``nets``), the
MC-ELBO and its gradients (``train.elbo``), the optimizers and loops
(``train``), the experiment runner with its checkpoints and metrics
(``train.experiment``, ``train.checkpoint``, ``train.metrics``), the
configs and presets (``config``), the example scripts (``examples``, the
conv-LDS of BASELINE config 4 and the data-parallel config 5 among them),
the data layer (``data``) and data-parallel training over
``torch.distributed`` (``parallel``: rank meshes, the DP train step with
one all_reduce a step, process-group start-up, the time-sharded
smoother).
Every serial recursion is a
hand-written CUDA kernel in ``csrc/`` with a plain PyTorch twin for CPU
tensors.
"""
