"""Utilities of the port (twin of the JAX ``utils/``).  Only the bucketing
part is ported; profiling, debug, misc and the HLO tools are ROADMAP Queue 1
items 12 and 13."""
from .bucketing import default_buckets, frame_mask, pad_to_bucket

__all__ = ["default_buckets", "pad_to_bucket", "frame_mask"]
