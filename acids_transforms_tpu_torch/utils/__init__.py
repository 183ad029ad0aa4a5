"""Utility layer of the port (twin of the JAX ``utils/``): audio IO,
bucketing, profiling, numerical guards and the collective recorder."""
from .bucketing import default_buckets, frame_mask, pad_to_bucket
from .collectives import collective_violations, record_collectives
from .debug import assert_finite, checked
from .misc import import_data, load_wav, resample, save_wav
from .profiling import annotate, device_timeit, trace

__all__ = [
    "collective_violations",
    "import_data",
    "load_wav",
    "save_wav",
    "resample",
    "trace",
    "annotate",
    "device_timeit",
    "checked",
    "assert_finite",
    "default_buckets",
    "pad_to_bucket",
    "frame_mask",
]
