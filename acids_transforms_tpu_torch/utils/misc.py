"""Audio file IO and dataset assembly (twin of the JAX ``utils/misc.py``).

Equivalent of reference utils/misc.py:29-59 (``import_data``), built without
torchaudio: a self-contained RIFF/WAVE parser (PCM 16/24/32, IEEE float32,
EXTENSIBLE, BWF ``bext`` chunks are skipped gracefully) and a Kaiser-windowed
sinc polyphase resampler, in numpy.  ``import_data`` loads and resamples
through the native C++ layer (``native/wavio.cc``, built at first use); the
numpy functions here are its plain versions and oracle.  Everything returns
numpy arrays.
"""
from __future__ import annotations

import math
import os
import struct
from fractions import Fraction
from typing import List, Tuple

import numpy as np

__all__ = ["load_wav", "load_wav_pcm", "save_wav", "resample", "import_data"]


def _parse_riff(path: str):
    """RIFF/WAVE chunk walk -> ``(audio_format, channels, sr, bits, payload)``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("%s is not a RIFF/WAVE file" % path)

    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4: pos + 8])
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise ValueError("%s: missing fmt/data chunk" % path)

    (audio_format, channels, sr, _byte_rate, _block_align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        (audio_format,) = struct.unpack("<H", fmt[24:26])
    return audio_format, channels, int(sr), bits, payload


def load_wav_pcm(path: str) -> Tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV as raw ``int16 (channels, n_samples)``.

    The raw-ingest fast path: samples stay wire-format int16 end to end —
    the fused kernels convert on the device (``x / 32768``, bit-identical to
    :func:`load_wav`'s float output; ops/cuda/spectral.py:fused_melspec)
    at half the input traffic.  Only format-1 16-bit files qualify; anything
    else raises (use :func:`load_wav` — a silent float fallback would
    defeat the caller's PCM contract).
    """
    audio_format, channels, sr, bits, payload = _parse_riff(path)
    if audio_format != 1 or bits != 16:
        raise ValueError(
            "%s is not 16-bit PCM (format %d, %d bits); use load_wav"
            % (path, audio_format, bits)
        )
    x = np.frombuffer(payload, dtype="<i2")
    n = (x.shape[0] // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), sr


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> ``(float32 array (channels, n_samples), sample_rate)``."""
    audio_format, channels, sr, bits, payload = _parse_riff(path)

    if audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(payload, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(payload, dtype="<f8").astype(np.float32)
        else:
            raise ValueError("unsupported float bit depth %d" % bits)
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError("unsupported PCM bit depth %d" % bits)
    else:
        raise ValueError("unsupported WAV format code %d" % audio_format)

    n = (x.shape[0] // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), sr


def save_wav(path: str, x: np.ndarray, sr: int = 44100, pcm16: bool = False) -> None:
    """Write ``(channels, n)`` or ``(n,)`` float audio to a WAV file."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    channels, n = x.shape
    interleaved = np.ascontiguousarray(x.T)
    if pcm16:
        body = (np.clip(interleaved, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        bits, fmt_code = 16, 1
    else:
        body = interleaved.astype("<f4").tobytes()
        bits, fmt_code = 32, 3
    block_align = channels * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_code, channels, sr, sr * block_align, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as f:
        f.write(hdr + body)


def _sinc_taps(t: np.ndarray, fc: float, half_width: float, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass evaluated at (fractional) offsets ``t``."""
    w = np.zeros_like(t)
    inside = np.abs(t) <= half_width
    ti = t[inside]
    kaiser = np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - (ti / half_width) ** 2))) / np.i0(beta)
    w[inside] = 2.0 * fc * np.sinc(2.0 * fc * ti) * kaiser
    return w


def resample(
    x: np.ndarray, sr_in: int, sr_out: int, zeros: int = 24, beta: float = 9.0
) -> np.ndarray:
    """Rational-ratio resampling of the last axis via Kaiser-windowed sinc.

    Polyphase evaluation: output sample ``m`` sits at input time
    ``m * down / up``; there are only ``up`` distinct fractional offsets, so
    taps are computed once per phase and applied as a batched gather+dot.
    """
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    frac = Fraction(sr_out, sr_in).limit_denominator(1 << 16)
    up, down = frac.numerator, frac.denominator
    fc = 0.5 * min(1.0, up / down)  # anti-alias cutoff in input units
    half_width = zeros / (2.0 * fc)
    K = int(math.ceil(half_width))

    x = np.asarray(x, dtype=np.float64)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    n_in = x.shape[-1]
    n_out = int(math.ceil(n_in * up / down))
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(K, K)])  # zero edges

    out = np.zeros(x.shape[:-1] + (n_out,), dtype=np.float64)
    m = np.arange(n_out)
    base = (m * down) // up
    phase = (m * down) % up
    ks = np.arange(-K, K + 1)
    for r in range(up):
        ms = np.flatnonzero(phase == r)
        if ms.size == 0:
            continue
        taps = _sinc_taps(r / up - ks.astype(np.float64), fc, half_width, beta)
        idx = base[ms, None] + ks[None, :] + K  # offset into padded signal
        out[..., ms] = np.einsum("...mk,k->...m", xp[..., idx], taps)
    out = out.astype(np.float32)
    return out[0] if squeeze else out


def import_data(
    path: str, sr: int = 44100, pcm: bool = False, return_mask: bool = False
):
    """Load a WAV file or a directory of WAVs (reference utils/misc.py:29-59).

    Directory mode zero-pads every file to the longest, harmonizes channel
    counts (any stereo file promotes all to stereo), and stacks to a batch.
    Returns ``(float32 array, name_or_names)``.

    ``pcm=True`` keeps 16-bit PCM files wire-format **int16** end to end
    (zero-padding is exact: 0 == 0.0/32768) for the fused kernels' raw
    ingest contract (:func:`load_wav_pcm`); files needing a resample to
    ``sr`` raise (resampling is float math), as do non-16-bit formats.

    ``return_mask=True`` appends a float32 validity mask (1 = real sample,
    0 = batch padding) shaped ``(1, L)`` for a single file and
    ``(B, 1, L)`` for a directory — broadcastable to the returned array
    and accepted directly by the pure ``fit(x, mask=)`` API, which
    excludes the padded samples (and the frames starting in them) from
    every fitted statistic (transforms/base.py).
    """
    if os.path.isfile(path):
        if pcm:
            x, sr_file = load_wav_pcm(path)
            if sr_file != sr:
                raise ValueError(
                    "%s is %d Hz but %d Hz was requested: resampling needs "
                    "float math; load with pcm=False" % (path, sr_file, sr)
                )
            if return_mask:
                return x, os.path.basename(path), np.ones(
                    (1, x.shape[1]), np.float32
                )
            return x, os.path.basename(path)
        from ..native import wavio_native

        x, sr_file = wavio_native.load_wav(path)
        if sr_file != sr:
            x = wavio_native.resample(x, sr_file, sr)
        if return_mask:
            return x, os.path.basename(path), np.ones(
                (1, x.shape[1]), np.float32
            )
        return x, os.path.basename(path)
    if os.path.isdir(path):
        from ..native import build

        build.load()  # a failed build raises here, not as "no readable audio"
        data: List[np.ndarray] = []
        names: List[str] = []
        for fname in sorted(os.listdir(path)):
            try:
                # pcm rides through: non-qualifying files fall under the
                # directory mode's existing skip-unreadable semantics
                x, name = import_data(os.path.join(path, fname), sr=sr, pcm=pcm)
            except Exception:
                continue
            data.append(x)
            names.append(os.path.splitext(os.path.basename(fname))[0])
        if not data:
            raise FileNotFoundError("no readable audio in %s" % path)
        lengths = [d.shape[1] for d in data]
        max_size = max(lengths)
        stereo = any(d.shape[0] == 2 for d in data)
        for i, d in enumerate(data):
            if d.shape[0] > 1:
                d = d if stereo else d[:1]
            else:
                d = np.concatenate([d, d], axis=0) if stereo else d
            if d.shape[1] < max_size:
                d = np.pad(d, ((0, 0), (0, max_size - d.shape[1])))
            data[i] = d
        if return_mask:
            mask = np.zeros((len(data), 1, max_size), np.float32)
            for i, n in enumerate(lengths):
                mask[i, :, :n] = 1.0
            return np.stack(data), names, mask
        return np.stack(data), names
    raise FileNotFoundError(path)
