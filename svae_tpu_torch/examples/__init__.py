"""Example scripts of the port, one per BASELINE config: ``python -m
svae_tpu_torch.examples.<name> [--preset name] [--field value ...]
[--device cpu]``."""
