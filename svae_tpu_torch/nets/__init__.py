"""Recognition and decoder networks: the MLP and residual stacks with
their Gaussian heads (``mlp``), the recognizers (``recognition``) and the
decoders (``decoders``)."""

from svae_tpu_torch.nets import decoders, mlp, recognition

__all__ = ["mlp", "recognition", "decoders"]
