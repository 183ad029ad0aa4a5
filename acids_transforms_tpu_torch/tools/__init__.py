"""Measuring tools of the port that run on the card (``python -m
acids_transforms_tpu_torch.tools.<name>``)."""
