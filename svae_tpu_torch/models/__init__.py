"""Structured priors: the GMM, LDS and SLDS models and the streaming
helpers of their online filters."""

from svae_tpu_torch.models import gmm, lds, slds, streaming

__all__ = ["gmm", "lds", "slds", "streaming"]
