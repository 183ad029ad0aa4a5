"""Native (C++) host layer (twin of the JAX ``native/``).

* ``pghi_native``: the exact magnitude-ordered heap PGHI, the serial,
  data-dependent phase integration that stays on the host
  (``STFT.pghi_exact``).
* ``wavio_native``: WAV decode / encode and the polyphase resampler
  (``utils.misc.import_data``).

The library is built from the sources beside this file at first use
(``build.py``); a failed build raises.
"""
from . import pghi_native, wavio_native  # noqa: F401

__all__ = ["pghi_native", "wavio_native"]
