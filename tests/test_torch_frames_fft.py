"""The FFT route of the session encode (R, the magnitude encode of N) and of
the full-K melspec front end (E, F): ``ops/cuda/frames_fft.py`` and the
wrappers that pick it.

* ``frames_rfft_reference`` (the plain version of ``csrc/fft_smem.cuh:
  frames_rfft``, in its schedule) against a float64 ``np.fft.rfft`` oracle
  and against the product plain versions, within 1e-5 of the largest
  magnitude (float32 sums over 2.5 n log2 n terms: a few 1e-7), at every
  size the route takes, under hann and the DGT's gaussian, with an odd frame
  count (the last frame pairs with a zero frame) and on a ragged session;
* R, N's encode, E and F through their public entry points on the CPU
  (where they run these plain versions) against the JAX package's Pallas
  kernels in interpret mode, within 1e-4 of the largest value as the
  existing tests of R and E hold them (the TPU products are bf16x3/x4);
* the route rule: ``n_fft`` alone picks it, and every shape the two kernels
  took before the FFT route existed is still taken, by one route or the
  other.

On the card ``chip_smoke.py`` holds the kernels against these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import spectral as JSP
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.ops.cuda import spectral as SP
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.cuda.frames_fft import (
    fft_covers,
    fft_covers_smooth,
    fft_covers_smooth7,
    frames_rfft_reference,
)
from acids_transforms_tpu_torch.ops.fft import _dft_matrices
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window
from test_torch_common import make_audio, rel, t2n

SIZES = [64, 128, 256, 512, 1024, 2048, 4096]


def window(name, n):
    return gaussian_dgt_window(n) if name == "gaussian" else get_window("hann", n)


def oracle(frames, w):
    return np.fft.rfft(np.float64(frames) * np.float64(w), axis=-1)


@pytest.mark.parametrize("wname", ["hann", "gaussian"])
@pytest.mark.parametrize("n", SIZES)
def test_reference_vs_float64_oracle_and_product(n, wname):
    rng = np.random.default_rng(n)
    frames = rng.standard_normal((2, 5, n)).astype(np.float32)   # 5 frames: the last pairs with zeros
    frames[1, 2] *= 1e-3                                           # a quiet frame beside a loud one
    w = window(wname, n)
    re, im = frames_rfft_reference(torch.as_tensor(frames), w)
    assert re.shape == im.shape == (2, 5, n // 2 + 1) and re.dtype == torch.float32
    got = t2n(re).astype(np.float64) + 1j * t2n(im)
    assert rel(got, oracle(frames, t2n(w))) <= 1e-5
    C, S = (torch.as_tensor(m) for m in _dft_matrices(n))
    wf = torch.as_tensor(frames) * w
    assert rel(t2n(re), t2n(torch.matmul(wf, C))) <= 1e-5
    assert rel(t2n(im), t2n(torch.matmul(wf, S))) <= 1e-5
    # a single frame (odd, and its own pair's only member)
    re1, im1 = frames_rfft_reference(torch.as_tensor(frames[:1, 3:4]), w)
    assert rel(t2n(re1) + 1j * t2n(im1), oracle(frames[:1, 3:4], t2n(w))) <= 1e-5


def test_reference_refuses_other_sizes():
    for n in (32, 768, 1200, 8192):
        assert not fft_covers(n)
        with pytest.raises(ValueError, match="power of two"):
            frames_rfft_reference(torch.zeros(1, 2, n), torch.ones(n))


@pytest.mark.parametrize("n_fft,hop,chunk", [(512, 128, 1024), (2048, 512, 2048)])
def test_ragged_session_encode_vs_oracle(n_fft, hop, chunk):
    """R's plain version on a ragged session (the last chunk zero padded) and
    an odd frame count against the float64 oracle of the row-padded signal."""
    x = make_audio(5, batch=2, n=2 * chunk + 300)[:, 0]
    n_frames = 3 * chunk // hop - 1                                 # odd
    rt = PT.RealtimeDGT(n_fft=n_fft, hop_length=hop, device="cpu")
    re, im = PK.session_encode_reference(torch.as_tensor(x), rt.window, n_fft, hop, n_frames)
    rows = np.pad(np.float64(x), ((0, 0), (n_fft - hop, (n_frames - 1) * hop + hop - x.shape[-1])))
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    assert rel(t2n(re) + 1j * t2n(im), oracle(rows[:, idx], t2n(rt.window))) <= 1e-5
    mag = PK.session_magnitude_reference(torch.as_tensor(x), rt.window, n_fft, hop, n_frames)
    assert torch.equal(mag, torch.sqrt(re * re + im * im))


def _session_chains(n_fft, hop, dgt):
    if dgt:
        return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeDGT(n_fft=n_fft, hop_length=hop),
                PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeDGT(n_fft=n_fft, hop_length=hop, device="cpu"))
    return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop),
            PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu"))


@pytest.mark.parametrize("n_fft,hop,dgt", [(512, 128, False), (1024, 256, True)])
def test_r_and_magnitude_encode_vs_pallas(n_fft, hop, dgt):
    chunk = 2 * n_fft
    x = make_audio(21, batch=2, n=2 * chunk + 300)[:, 0]            # 3 chunks, ragged tail
    jc, pc = _session_chains(n_fft, hop, dgt)
    spec_p, _ = PK.make_fused_forward_session(pc, chunk)(torch.as_tensor(x))
    spec_j, _ = JK.make_fused_forward_session(jc, chunk, interpret=True)(jnp.asarray(x))
    spec_j = np.array(spec_j)
    assert spec_p.shape == spec_j.shape == (2, 3 * chunk // hop, n_fft // 2 + 1)
    assert rel(t2n(spec_p), spec_j) <= 1e-4
    mag_p = PK.make_fused_magnitude_session(pc, chunk)(torch.as_tensor(x))
    assert mag_p.shape == spec_p.shape and rel(t2n(mag_p), np.abs(spec_j)) <= 1e-4


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256)])
def test_e_and_f_vs_pallas(n_fft, hop):
    x = make_audio(23, batch=2, n=6 * hop + 37)[:, 0]               # T = 7: odd, no whole tile
    w = gaussian_dgt_window(n_fft)
    kw = dict(offset=0.25, scale=1.5, contrast="log1p", taps=None)
    y_p = SP.fused_melspec(torch.as_tensor(x), n_fft, hop, window=w, **kw)
    y_j = JSP.fused_melspec(jnp.asarray(x), n_fft, hop, jnp.asarray(t2n(w)), interpret=True, **kw)
    assert y_p.shape == y_j.shape == (2, 7, n_fft // 2 + 1)
    assert rel(t2n(y_p), np.array(y_j)) <= 1e-4
    s_p = SP.fused_melspec_stats(torch.as_tensor(x), n_fft, hop, "log1p", taps=None, window=w)
    s_j = JSP.fused_melspec_stats(jnp.asarray(x), n_fft, hop, jnp.asarray(t2n(w)), "log1p", interpret=True)
    assert s_p["count"] == int(s_j["count"])
    for k in ("sum", "sumsq"):
        assert abs(float(s_p[k]) - float(s_j[k])) <= 1e-4 * abs(float(s_j[k]))
    for k in ("min", "max"):
        assert abs(float(s_p[k]) - float(s_j[k])) <= 1e-4 * max(1.0, abs(float(s_j["max"])))


def _shapes():
    """(n_fft, hop) of every overlap 2..8: powers of two 32..8192 and the
    other sizes the chains use (768, 960, 1200, 1536, 3072)."""
    out = []
    for n in [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 768, 960, 1200, 1536, 3072]:
        for ov in range(2, 9):
            if n % ov == 0:
                out.append((n, n // ov))
    return out


def test_route_rule_and_coverage():
    """n_fft alone picks the route, and no shape the kernels took before the
    FFT route existed (the product's gates, which the code still computes) is
    lost.  The product route keeps every other shape."""
    assert [n for n in range(16, 9000) if fft_covers(n)] == SIZES
    for n_fft, hop in _shapes() + [(1200, 300), (960, 240), (768, 256), (896, 224)]:
        F = n_fft // 2 + 1
        # R and the magnitude encode (the encode gate before the FFT route)
        old_encode = hop % 4 == 0 and PK._pick_rows("encode", n_fft, hop) is not None
        if old_encode:
            assert PK.kernel_covers("encode", n_fft, hop), (n_fft, hop)
            rows, teams = PK._encode_plan(n_fft, hop)
            assert (teams > 0) == (fft_covers(n_fft) or fft_covers_smooth7(n_fft)), (n_fft, hop)
            if teams:
                assert rows % 2 == 0 and PK._encode_fft_smem_bytes(rows, hop, n_fft, teams) <= PK.MAX_SMEM
        # E and F (the full-K gate and tile before the FFT route)
        old_melspec = (SP.fused_melspec_available(n_fft, hop, None)
                       and SP._pick_tile(hop, n_fft // hop, F) is not None)
        if old_melspec:
            tile_t, teams = SP._kernel_plan(n_fft, hop, None)
            assert (teams > 0) == (fft_covers(n_fft) or fft_covers_smooth7(n_fft)), (n_fft, hop)
            if teams:
                assert SP._fft_smem_bytes(tile_t, hop, n_fft // hop, F, teams) <= SP.MAX_SMEM
            else:
                assert tile_t == SP._pick_tile(hop, n_fft // hop, F)
        # with taps (A and B) the FFT route where fft_covers and the smooth
        # route where fft_covers_smooth7, E's and F's plan; the factored front
        # end and its tile elsewhere
        if SP.fused_melspec_available(n_fft, hop, (0.5, -0.25)) and SP._pick_tile(hop, n_fft // hop, F):
            if fft_covers(n_fft) or fft_covers_smooth7(n_fft):
                assert SP._kernel_plan(n_fft, hop, (0.5, -0.25)) == SP._kernel_plan(n_fft, hop, None)
            else:
                assert SP._kernel_plan(n_fft, hop, (0.5, -0.25)) == (SP._pick_tile(hop, n_fft // hop, F), 0)
    # the named shapes, and the main shape
    assert PK._encode_plan(1024, 256) == (32, 4) and SP._kernel_plan(1024, 256, None) == (16, 4)
    # 1200 and 960 (5-smooth) on the smooth route, 1408 = 2^7 11 on the product,
    # 1344 = 2^6 3 7 on the smooth route's radix-7 stage
    assert PK._encode_plan(1200, 300) == (16, 2) and PK._encode_plan(960, 240)[1] > 0
    assert PK._encode_plan(1408, 352)[1] == 0
    assert PK._encode_plan(1344, 336)[1] > 0
    assert SP._kernel_plan(768, 256, None)[1] > 0 and SP._kernel_plan(896, 224, None)[1] > 0
    assert SP._kernel_plan(1408, 352, None)[1] == 0
    assert SP._kernel_plan(4096, 1024, None)[0] == 8       # n_fft 4096: a tile of 8 frames


def test_no_route_counted_on_the_cpu():
    _, pc = _session_chains(512, 128, False)
    SP.reset_launches()
    PK.reset_launches()
    PK.make_fused_forward_session(pc, 1024)(torch.zeros(2, 3000))
    SP.fused_melspec(torch.zeros(2, 3000), 512, 128, taps=None, window=torch.ones(512))
    assert not any(PK.routes.values()) and not any(SP.routes.values())
    assert set(PK.routes) == {"session_encode:fft", "session_encode:smooth", "session_encode:product",
                              "session_magnitude:fft", "session_magnitude:smooth", "session_magnitude:product",
                              "session_roundtrip:fft", "session_roundtrip:smooth", "session_roundtrip:product",
                              "session_random_roundtrip:fft", "session_random_roundtrip:smooth",
                              "session_random_roundtrip:product",
                              "session_random_decode:fft", "session_random_decode:smooth",
                              "session_random_decode:product",
                              "session_complex_decode:fft", "session_complex_decode:smooth",
                              "session_complex_decode:product",
                              "gl_project_synthesis:fft", "gl_project_synthesis:smooth",
                              "gl_project_synthesis:product", "gl_polish:fft", "gl_polish:smooth",
                              "gl_project_analysis:fft", "gl_project_analysis:smooth",
                              "gl_project_analysis:product"}
    assert set(SP.routes) == {"fused_melspec_fullk:fft", "fused_melspec_fullk:smooth", "fused_melspec_fullk:product",
                              "fused_melspec_stats_fullk:fft", "fused_melspec_stats_fullk:smooth",
                              "fused_melspec_stats_fullk:product",
                              "fused_spectral_repr_fullk:fft", "fused_spectral_repr_fullk:smooth",
                              "fused_spectral_repr_fullk:product",
                              "fused_repr_stats_fullk:fft", "fused_repr_stats_fullk:smooth",
                              "fused_repr_stats_fullk:product",
                              "fused_melspec:fft", "fused_melspec:smooth", "fused_melspec:factored",
                              "fused_melspec_stats:fft", "fused_melspec_stats:smooth",
                              "fused_melspec_stats:factored",
                              "fused_spectral_repr:fft", "fused_spectral_repr:smooth", "fused_spectral_repr:factored",
                              "fused_repr_stats:fft", "fused_repr_stats:smooth", "fused_repr_stats:factored"}

