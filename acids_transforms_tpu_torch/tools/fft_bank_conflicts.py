"""Shared-memory bank conflicts of the mixed-radix FFT's stages, counted from
their address pattern (``csrc/fft_smem.cuh:fft_smooth_stage``): no card is
needed and none is measured.

Usage::

    python -m acids_transforms_tpu_torch.tools.fft_bank_conflicts [1200 960 768 ...]

For each stage of :func:`frames_fft.fft_radices` (radix ``r`` of 2, 3, 4, 5
and 7: the radix-7 stages of R's and L's instances at a size with a factor
7, 896 and 1344 among the defaults; stride ``s``)
a warp's 32 lanes read ``x[b + k n / r]`` and write ``y[r (b - q) + q + s
k]`` (``q = b mod s``; the last stage writes where it reads), one access per
butterfly round ``u`` and ``k < r``, for ``re`` and for ``im`` alike.  An
access costs as many shared-memory wavefronts as the most distinct 4-byte
words that fall on one of the 32 banks ("ways"; one word read by several
lanes is a broadcast).  Teams of fewer than 32 threads share a warp, each on
its own buffer (``frames_fft.fft_smooth_buf_floats`` apart).  The report:
per stage the worst and the mean ways of its reads and of its writes.
"""
from __future__ import annotations

import sys
from typing import Dict, List

from ..ops.cuda.frames_fft import fft_radices, fft_smooth_buf_floats, fft_smooth_team_threads

BANKS = 32


def ways(addresses: List[int]) -> int:
    """Wavefronts of one warp access: the most distinct words on one bank."""
    per_bank: Dict[int, set] = {}
    for a in addresses:
        per_bank.setdefault(a % BANKS, set()).add(a)
    return max((len(v) for v in per_bank.values()), default=0)


def _lanes(n: int):
    """``(base, j)`` of each lane of each warp of the first team(s): the
    buffer offset of its team and its index in the team."""
    g = fft_smooth_team_threads(n)
    if g < BANKS:
        buf = fft_smooth_buf_floats(n)
        return [[((lane // g) * buf, lane % g) for lane in range(BANKS)]]
    return [[(0, w * BANKS + lane) for lane in range(BANKS)] for w in range(g // BANKS)]


def stage_conflicts(n: int) -> List[dict]:
    """Per stage ``{"radix", "stride", "read_max", "read_mean", "write_max",
    "write_mean"}`` over every warp of a team and every access."""
    g = fft_smooth_team_threads(n)
    rad = fft_radices(n)
    out, s = [], 1
    for st, r in enumerate(rad):
        nb = n // r
        last = st == len(rad) - 1
        reads, writes = [], []
        for warp in _lanes(n):
            for u in range(-(-nb // g)):
                for k in range(r):
                    ra, wa = [], []
                    for base, j in warp:
                        b = j + u * g
                        if b >= nb:
                            continue
                        ra.append(base + b + k * nb)
                        q = b % s
                        wa.append(base + (b + k * nb if last else r * (b - q) + q + s * k))
                    if ra:
                        reads.append(ways(ra))
                        writes.append(ways(wa))
        out.append(dict(radix=r, stride=s, read_max=max(reads), read_mean=sum(reads) / len(reads),
                        write_max=max(writes), write_mean=sum(writes) / len(writes)))
        s *= r
    return out


def main(argv: List[str]) -> int:
    sizes = [int(a) for a in argv] or [1200, 960, 768, 400, 1920, 896, 1344]
    for n in sizes:
        print("n_fft %d: team of %d threads, radices %s" % (n, fft_smooth_team_threads(n), fft_radices(n)))
        for row in stage_conflicts(n):
            print("  radix %d stride %4d: reads %d-way at most (mean %.2f), writes %d-way at most (mean %.2f)" % (
                row["radix"], row["stride"], row["read_max"], row["read_mean"], row["write_max"], row["write_mean"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
