"""The mixed-radix (smooth) route's radix-7 stage, which R, N's magnitude
encode, L, M and the decodes (P, S, O's projection synthesis) take at an
even ``n_fft`` with a factor 7
(``ops/cuda/frames_fft.py``: ``fft_covers_smooth7``, the sevens of
``fft_radices``, the radix-7 butterfly of the ``smooth=True`` schedule) and
the session wrappers that pick it (``ops/cuda/stream_step.py:session_route``
with the kernel's kind and hop).

* the rule: the exact list of sizes it takes, ``fft_covers`` and
  ``fft_covers_smooth`` unchanged;
* the radix plan (sevens first), the team, its buffer and the twiddle
  table; every even 5-smooth size keeps its plan;
* the radix-7 constants shared with ``csrc/fft_smem.cuh``;
* the plain schedule against a float64 ``np.fft`` oracle and against the DFT
  products, within 1e-5 of the largest value, at 112 to 4032 under hann and
  the DGT's gaussian, with an odd frame count;
* the plain R, N's encode, L and M at 1344/336 and 896/224 against the JAX
  package's generic chunk scan (it has no session layout at these shapes)
  within 1e-4 of the largest value and against the float64 session oracle
  within 1e-5;
* the route rule: R, L and the decodes on the smooth route at every even
  7-smooth shape their blocks fit, O's polish and the other kernels on their
  product routes there, the four 4032 roundtrip shapes whose smooth block
  does not fit on the product; every shape the encode, roundtrip and decode
  gates took before still taken; no route counted on the CPU
  (``tests/test_torch_stream_decode_seven.py`` holds the decodes' plain
  versions).

On the card ``chip_smoke.py`` holds the kernels' radix-7 instances against
these plain versions (bit-identical at 1344/336 and 896/224).
"""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu import streaming as JS
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import glstep as GS
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PGK
from acids_transforms_tpu_torch.ops.cuda import spectral as SP
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.fft import _dft_matrices
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_kernel import oracle as session_oracle

SIZES = [112, 224, 448, 672, 840, 896, 1344, 1680, 1764, 2688, 4032]
SESSION_SHAPES = [(1344, 336), (896, 224)]
HEADER = os.path.join(os.path.dirname(PK.__file__), "..", "..", "csrc", "fft_smem.cuh")
# the four shapes the roundtrip gate takes at 4032 whose smooth block does not
# fit shared memory (overlap 4, 6, 7, 8); the product block does
PRODUCT_4032 = [(4032, 1008), (4032, 672), (4032, 576), (4032, 504)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def window(name, n):
    return gaussian_dgt_window(n) if name == "gaussian" else get_window("hann", n)


def sevens():
    return [n for n in range(64, 4097) if FF.fft_covers_smooth7(n) and not FF.fft_covers_smooth(n)]


def test_rule_takes_the_even_7_smooth_sizes():
    smooth = sorted({2 ** a * 3 ** b * 5 ** c * 7 ** d for a in range(1, 13) for b in range(8) for c in range(6)
                     for d in range(5)})
    expect = [n for n in smooth if 64 <= n <= 4096 and n & (n - 1)]
    assert [n for n in range(16, 9000) if FF.fft_covers_smooth7(n)] == expect
    assert all(FF.fft_covers_smooth7(n) for n in range(16, 9000) if FF.fft_covers_smooth(n))
    assert sevens()[:6] == [70, 84, 98, 112, 126, 140] and sevens()[-3:] == [3780, 3920, 4032]
    assert len(sevens()) == 76 and {896, 1344, 1680, 1764, 1792, 2688, 4032} <= set(sevens())
    assert not any(FF.fft_covers_smooth7(n) for n in (1408, 1056, 1001, 4116, 8064, 56, 4096, 1024))
    # the power-of-two and the 5-smooth rules are as they were
    assert [n for n in range(16, 9000) if FF.fft_covers(n)] == [64, 128, 256, 512, 1024, 2048, 4096]
    five = sorted({2 ** a * 3 ** b * 5 ** c for a in range(1, 13) for b in range(8) for c in range(6)})
    assert [n for n in range(16, 9000) if FF.fft_covers_smooth(n)] == [n for n in five if 64 <= n <= 4096
                                                                        and n & (n - 1)]


def _old_radices(n):
    """``fft_radices`` before the radix-7 stage: fives, threes, fours, a two."""
    out = []
    for p in (5, 3):
        while n % p == 0:
            out.append(p)
            n //= p
    while n % 4 == 0:
        out.append(4)
        n //= 4
    if n == 2:
        out.append(2)
    return tuple(out)


def test_radix_plan_team_buffer_and_table():
    for n in sevens():
        rad = FF.fft_radices(n)
        assert math.prod(rad) == n and list(rad) == sorted(rad, key=[7, 5, 3, 4, 2].index)
        assert rad[0] == 7 and rad.count(2) <= 1 and rad[-1] in (2, 4)
        g = FF.fft_smooth_team_threads(n)
        assert g & (g - 1) == 0 and 8 < n / g <= 16 and FF.fft_smooth_max_teams(n) == 256 // g
        s, need = 1, 0
        for r in rad[:-1]:
            need = max(need, (r - 1) * (n // r - 1 - (n // r - 1) % s))
            s *= r
        assert FF.fft_smooth_table(n) == need + 1 <= n
        buf = FF.fft_smooth_buf_floats(n)
        assert buf >= 4 * n and buf % 2 == 0 and (g >= 32 or buf % 32 == g)
    # every even 5-smooth size keeps its plan, tuple for tuple
    for n in range(64, 4097):
        if FF.fft_covers_smooth(n):
            assert FF.fft_radices(n) == _old_radices(n), n
    assert FF.fft_radices(896) == (7, 4, 4, 4, 2) and FF.fft_radices(1344) == (7, 3, 4, 4, 4)
    assert FF.fft_radices(1764) == (7, 7, 3, 3, 4) and FF.fft_radices(1680) == (7, 5, 3, 4, 4)
    assert [FF.fft_smooth_table(n) for n in (896, 1344, 4032)] == [763, 1147, 3451]
    assert FF.fft_smooth_team_threads(896) == 64 and FF.fft_smooth_team_threads(1344) == 128
    assert FF.fft_smooth_buf_floats(1344) == 4 * 1344 and FF.fft_smooth_buf_floats(112) == 4 * 112 + 8
    with pytest.raises(ValueError, match="7\\^d"):
        FF.fft_radices(1408)                                     # 2^7 11


def test_header_holds_the_radix_7_constants():
    text = open(HEADER).read()
    for k in ("C1", "C2", "C3", "S1", "S2", "S3"):
        m = re.search(r"constexpr float kR7%s = (-?0x[0-9a-fp.+-]+)f;" % k, text)
        assert m and float.fromhex(m.group(1)) == FF.SMOOTH_CONSTANTS["r7" + k.lower()], k
    c = FF.SMOOTH_CONSTANTS
    for j in (1, 2, 3):
        assert c["r7c%d" % j] == float(np.float32(np.cos(2 * np.pi * j / 7)))
        assert c["r7s%d" % j] == float(np.float32(np.sin(2 * np.pi * j / 7)))


def test_radix_7_butterfly_is_the_length_7_dft():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    yr, yi = FF._dft(7, list(torch.as_tensor(x[0])), list(torch.as_tensor(x[1])))
    got = np.stack([t2n(v) for v in yr]) + 1j * np.stack([t2n(v) for v in yi])
    ora = np.fft.fft(np.float64(x[0]) + 1j * np.float64(x[1]), axis=0)
    assert rel(got, ora) <= 1e-6


@pytest.mark.parametrize("wname", ["hann", "gaussian"])
@pytest.mark.parametrize("n", SIZES)
def test_seven_schedule_vs_float64_oracle_and_product(n, wname):
    rng = np.random.default_rng(n)
    frames = rng.standard_normal((2, 5, n)).astype(np.float32)   # 5 frames: the last pairs with zeros
    frames[1, 2] *= 1e-3
    w = window(wname, n)
    re_, im = FF.frames_rfft_reference(torch.as_tensor(frames), w, smooth=True)
    assert re_.shape == im.shape == (2, 5, n // 2 + 1) and re_.dtype == torch.float32
    got = t2n(re_).astype(np.float64) + 1j * t2n(im)
    ora = np.fft.rfft(np.float64(frames) * np.float64(t2n(w)), axis=-1)
    assert rel(got, ora) <= 1e-5
    C, S = (torch.as_tensor(m) for m in _dft_matrices(n))
    wf = torch.as_tensor(frames) * w
    assert rel(t2n(re_), t2n(torch.matmul(wf, C))) <= 1e-5
    assert rel(t2n(im), t2n(torch.matmul(wf, S))) <= 1e-5
    # pairs (r, r + 2) give the same spectra, and the inverse of them is the frames
    re2, im2 = FF.frames_rfft_reference(torch.as_tensor(frames), w, stride=2, smooth=True)
    assert rel(t2n(re2) + 1j * t2n(im2), ora) <= 1e-5
    wsyn = FF.irfft_window(w, n, smooth=True)
    y = FF.frames_irfft_reference(re_, im, wsyn, stride=2, smooth=True)
    y_o = np.fft.irfft(ora, n=n, axis=-1) * np.float64(t2n(w))      # irfft_window folds the 1 / n
    assert y.shape == (2, 5, n) and rel(t2n(y), y_o) <= 1e-5


def _session(n, hop, seed):
    chunk = 2 * n
    x = make_audio(seed, batch=2, n=3 * chunk - 500)[:, 0]          # a ragged last chunk
    jc = JT.OverlapAdd(n, hop) + JT.RealtimeSTFT(n_fft=n, hop_length=hop)
    pc = PT.OverlapAdd(n, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    assert PK.session_route(n, "encode") == "smooth" and PK.session_route(n, "roundtrip", hop) == "smooth"
    assert JS.plan_roundtrip(jc, x.shape, chunk) != "fused"
    T = 3 * chunk // hop
    return x, chunk, jc, pc, T


@pytest.mark.parametrize("n,hop", SESSION_SHAPES)
def test_r_and_magnitude_encode_vs_jax_scan_and_oracle(n, hop):
    x, chunk, jc, pc, T = _session(n, hop, n)
    spec, _ = PK.make_fused_forward_session(pc, chunk)(torch.as_tensor(x))
    jf, _ = JS.scan_forward(jc, jnp.asarray(x), chunk)
    assert spec.shape == jf.shape == (2, T, n // 2 + 1)
    assert rel(t2n(spec), np.array(jf)) <= 1e-4
    spec_o, _ = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), 4.0, n, hop, T)
    assert rel(t2n(spec), spec_o) <= 1e-5
    mag = PK.make_fused_magnitude_session(pc, chunk)(torch.as_tensor(x))
    assert mag.shape == (2, T, n // 2 + 1)
    assert rel(t2n(mag), np.abs(np.array(jf))) <= 1e-4 and rel(t2n(mag), np.abs(spec_o)) <= 1e-5
    assert torch.equal(mag, PK.session_magnitude_reference(torch.as_tensor(x), pc[1].window, n, hop, T))
    # the session's plain version is the radix-7 schedule itself
    re_, im = PK.session_encode_reference(torch.as_tensor(x), pc[1].window, n, hop, T)
    frames = PK.frame(PK.session_rows(torch.as_tensor(x), n, hop, T), n, hop)
    re_s, im_s = FF.frames_rfft_reference(frames, pc[1].window, smooth=True)
    assert torch.equal(re_, re_s) and torch.equal(im, im_s)


@pytest.mark.parametrize("n,hop", SESSION_SHAPES)
def test_l_and_m_vs_jax_scan_and_oracle(n, hop):
    x, chunk, jc, pc, T = _session(n, hop, n + 1)
    gain = float(pc[0].gain_compensation)
    y = PK.make_fused_roundtrip(pc, chunk)(torch.as_tensor(x))
    jy = JS.scan_roundtrip(jc, jnp.asarray(x), chunk)
    assert y.shape == jy.shape == (2, 3 * chunk)
    assert rel(t2n(y), np.array(jy)) <= 1e-4
    _, y_o = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), gain, n, hop, T)
    assert rel(t2n(y), y_o) <= 1e-5
    # M with the generic scan's own draws (JK._session_angles replays its key pipeline)
    key, F = jax.random.PRNGKey(n), n // 2 + 1
    ang = np.array(JK._session_angles(key, 3, chunk // hop, F, F, (2,)))[..., :F]
    ym = PK.make_fused_random_roundtrip(pc, chunk, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    jm = JS.scan_roundtrip(jc, jnp.asarray(x), chunk, "random", key=key)
    assert ym.shape == jm.shape and rel(t2n(ym), np.array(jm)) <= 1e-4
    _, m_o = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), gain, n, hop, T, angles=ang)
    assert rel(t2n(ym), m_o) <= 1e-5


# the radix-7 roundtrip at every other overlap its gate takes (2, 3, 5, 6, 7,
# 8; two sevens at 1764 and 3528)
OVERLAP_SHAPES = [(4032, 2016), (1764, 588), (1680, 336), (1344, 224), (3528, 504), (1344, 168)]


@pytest.mark.parametrize("n,hop", OVERLAP_SHAPES)
def test_l_and_m_at_other_overlaps_vs_oracle(n, hop):
    """L and M's plain versions on the radix-7 schedule, through the sessions,
    within 1e-5 of the float64 oracle under the chain's own gain (the
    overlap: a gain of another overlap scales every sample by its ratio)."""
    chunk = 2 * n
    pc = PT.OverlapAdd(n, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    assert PK.session_route(n, "roundtrip", hop) == "smooth" and PK._roundtrip_plan(n, hop)[1] > 0
    x = make_audio(n + hop, batch=2, n=2 * chunk - 300)[:, 0]
    T, F, gain = 2 * chunk // hop, n // 2 + 1, float(pc[0].gain_compensation)
    assert gain == n // hop
    y = PK.make_fused_roundtrip(pc, chunk)(torch.as_tensor(x))
    _, y_o = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), gain, n, hop, T)
    assert y.shape == (2, T * hop) and rel(t2n(y), y_o) <= 1e-5
    assert torch.equal(y, PK.session_roundtrip_reference(torch.as_tensor(x), pc[1].window, pc[1].inv_window,
                                                         gain, n, hop, T))
    # the plain version under overlap 4's gain reads 4 / overlap - 1 off
    y4 = PK.session_roundtrip_reference(torch.as_tensor(x), pc[1].window, pc[1].inv_window, 4.0, n, hop, T)
    assert abs(rel(t2n(y), t2n(y4)) - abs(4.0 / gain - 1.0)) <= 1e-5
    ang = np.random.default_rng(n + hop).uniform(0, 2 * np.pi, (2, T, F)).astype(np.float32)
    ym = PK.make_fused_random_roundtrip(pc, chunk, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    _, m_o = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), gain, n, hop, T, angles=ang)
    assert ym.shape == (2, T * hop) and rel(t2n(ym), m_o) <= 1e-5


def test_route_rule():
    """R, L and the decodes smooth at the 7-smooth shapes; the polish and the
    other kernels on their product routes there; 4032's four large-overlap
    roundtrips on the product; the plans."""
    for n, hop in SESSION_SHAPES + [(1792, 448), (1680, 420), (1764, 588)]:
        assert PK.session_route(n, "encode") == "smooth" and PK.session_route(n, "roundtrip", hop) == "smooth"
        assert PK._encode_plan(n, hop)[1] > 0 and PK._roundtrip_plan(n, hop)[1] > 0
        # the decodes and O's polish: n_fft alone, their radix-7 instances
        assert PK.session_route(n, "polish") == "smooth" and PK.session_route(n, "decode", hop) == "smooth"
        assert PK._decode_plan(n, hop)[1] > 0 and PK._decode_plan(n, hop, PK.PROJECT_SYN_ROWS)[1] > 0
        assert PK._polish_plan(n, hop, 20) is not None
    # the Griffin-Lim steps C, D and I keep fft_covers_smooth: their product route at 896/224 and
    # 1344/336 (E, F, A, B, G, H, K's synthesis and J take their radix-7 instance there)
    for n, hop in SESSION_SHAPES:
        assert SP.melspec_route(n) == "smooth"
        assert GS.gl_step_route(n, hop) == "product" and PGK.synth_route(n, hop) == "smooth"
    assert SP._kernel_plan(896, 224, None)[1] > 0 and SP._repr_plan(896, 224, None, False, "if", True)[1] > 0
    assert GS._fullk_plan(896, 224)[0] == "smooth"
    for n, hop in PRODUCT_4032:
        assert PK.session_route(n, "encode") == "smooth" and PK.session_route(n, "roundtrip", hop) == "product"
        assert PK._roundtrip_fft_plan(n, hop, True) is None
        assert PK._roundtrip_plan(n, hop) == (PK._pick_rows("roundtrip", n, hop), 0)
        assert PK.kernel_covers("roundtrip", n, hop) and PK._encode_plan(n, hop)[1] > 0
    assert PK.session_route(4032, "roundtrip", 2016) == "smooth"      # overlap 2 fits
    with pytest.raises(ValueError, match="hop"):
        PK.session_route(1344, "roundtrip")
    # every caller names its kind: the encodes' and roundtrips' rule differs
    with pytest.raises(TypeError):
        PK.session_route(1344)
    with pytest.raises(ValueError, match="kind"):
        PK.session_route(1344, "synthesis")
    # 1408 = 2^7 11 on the products for every kernel
    assert PK.session_route(1408, "encode") == PK.session_route(1408, "roundtrip", 352) == "product"
    assert PK.session_route(1408, "decode") == "product" and PK._decode_plan(1408, 352)[1] == 0
    # the plans (frames_fft.class_plan_smooth, _encode_plan's rule): on an H100
    # the fastest of a sweep of every plan (chip_smoke.py:seven_plan_sweep)
    # at every one of these shapes but L / M at 1344/336 and 896/224, 4.8 %
    # and 0.9 % over 56 chunks of 2 and 4 FFTs
    assert PK._encode_plan(1344, 336) == (16, 2) and PK._encode_plan(896, 224) == (32, 4)
    assert PK._encode_plan(1792, 448) == (16, 2) and PK._encode_plan(1680, 420) == (16, 2)
    assert PK._roundtrip_plan(1344, 336) == (8, 2) and PK._roundtrip_plan(896, 224) == (16, 4)
    assert PK._roundtrip_plan(1792, 448) == (24, 2) and PK._roundtrip_plan(1680, 420) == (40, 2)
    # operands: the window and the twiddles on the smooth route
    win, tw = PK._encode_operands(torch.hann_window(1344), 1344)
    assert win.shape == (1344,) and tw.shape == (2, 1344)
    pc = PT.OverlapAdd(1344, 336, device="cpu") + PT.RealtimeSTFT(n_fft=1344, hop_length=336, device="cpu")
    ops = PK._Session(pc, 8).roundtrip_operands()
    assert ops[:3] == (None, None, None) and ops[4].shape == (1344,) and ops[5].shape == (2, 1344)
    pc = PT.OverlapAdd(4032, 1008, device="cpu") + PT.RealtimeSTFT(n_fft=4032, hop_length=1008, device="cpu")
    assert PK._Session(pc, 8).roundtrip_operands()[3:] == (None, None, None)


def test_every_shape_taken_before_is_still_taken():
    """At every even 7-smooth n_fft with a seven (hop % 4 == 0, overlap 2 to
    8: 199 shapes) the gates take what the product's took, and each plan
    fits."""
    n_shapes = n_smooth = n_decode = 0
    for n in sevens():
        for ov in range(2, 9):
            if n % ov or (n // ov) % 4:
                continue
            hop = n // ov
            n_shapes += 1
            if PK._pick_rows("encode", n, hop) is not None:
                assert PK.kernel_covers("encode", n, hop), (n, hop)
            rows, teams = PK._encode_plan(n, hop)                  # every encode block fits
            assert rows % 2 == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
            assert PK._encode_fft_smem_bytes(rows, hop, n, teams) <= PK.MAX_SMEM
            if PK._pick_rows("roundtrip", n, hop) is not None:
                assert PK.kernel_covers("roundtrip", n, hop), (n, hop)
                rows, teams = PK._roundtrip_plan(n, hop)
                if PK.session_route(n, "roundtrip", hop) == "smooth":
                    n_smooth += 1
                    assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
                    assert PK._roundtrip_fft_smem_bytes(rows, ov, hop, teams) <= PK.MAX_SMEM
                else:
                    assert (n, hop) in PRODUCT_4032 and (rows, teams) == (PK._pick_rows("roundtrip", n, hop), 0)
            if PK._pick_rows("decode", n, hop) is not None:
                assert PK.kernel_covers("decode", n, hop), (n, hop)
            assert PK.session_route(n, "decode") == "smooth"
            for narrow in (None, PK.PROJECT_SYN_ROWS):             # P and S's blocks, O's narrow ones
                rows, teams = PK._decode_plan(n, hop, narrow)
                assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
                assert PK._decode_fft_smem_bytes(rows, hop, n, teams) <= PK.MAX_SMEM
            n_decode += PK.kernel_covers("decode", n, hop)
    assert n_shapes == 199 and n_smooth == 195 and n_decode == 199


def test_product_roundtrip_reference_keeps_the_products_where_the_encode_is_smooth():
    n, hop = 4032, 1008
    x = torch.as_tensor(make_audio(4, batch=1, n=3 * n)[:, 0])
    rt = PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    T = 3 * n // hop
    y = PK.session_roundtrip_reference(x, rt.window, rt.inv_window, 4.0, n, hop, T)
    _, y_o = session_oracle(t2n(x), t2n(rt.window), t2n(rt.inv_window), 4.0, n, hop, T)
    assert y.shape == (1, T * hop) and rel(t2n(y), y_o) <= 1e-5
    frames = PK.frame(PK.session_rows(x, n, hop, T), n, hop)
    WC, WS = PK._ana_basis(rt.window, n)
    y_p = PK._synthesize(torch.matmul(frames, WC), torch.matmul(frames, WS), rt.inv_window, 4.0, n, hop, T)
    assert torch.equal(y, y_p)


def test_no_route_counted_on_the_cpu():
    n, hop = 1344, 336
    pc = PT.OverlapAdd(n, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    PK.reset_launches()
    x = torch.as_tensor(make_audio(9, batch=2, n=6000)[:, 0])
    PK.make_fused_forward_session(pc, 2688)(x)
    PK.make_fused_magnitude_session(pc, 2688)(x)
    PK.make_fused_roundtrip(pc, 2688)(x)
    assert not any(PK.routes.values()) and not any(PK.launches.values())


def test_kernel_resources_compare_reads_the_seven_argument():
    """``tools/kernel_resources.py --compare`` matches an instance that gained
    a last template argument ``false`` (``kSeven`` here, any kernel's) with
    the instance it was, leaves a kernel the old report holds under its own
    name, and lists the new radix-7 instances as new."""
    from acids_transforms_tpu_torch.tools import kernel_resources as KR
    old = {"_ZN3att21session_encode_kernelILb0ELb1ELb1EEEvNS_11SessionArgsE": {"registers": 80},
           "_ZN3att28session_roundtrip_fft_kernelILb1ELb1EEEvNS_11SessionArgsE": {"registers": 72},
           "_ZN3att21session_decode_kernelILi1ELb0EEEvNS_11SessionArgsE": {"registers": 128},
           "_ZN3att25session_decode_fft_kernelILb0ELb1EEEvNS_11SessionArgsE": {"registers": 64},
           "_Z6kernelILi4EEvPf": {"registers": 32}}
    new = {"_ZN3att21session_encode_kernelILb0ELb1ELb1ELb0EEEvNS_11SessionArgsE": {"registers": 80},
           "_ZN3att21session_encode_kernelILb0ELb1ELb1ELb1EEEvNS_11SessionArgsE": {"registers": 95},
           "_ZN3att28session_roundtrip_fft_kernelILb1ELb1ELb0EEEvNS_11SessionArgsE": {"registers": 72},
           "_ZN3att21session_decode_kernelILi1ELb0EEEvNS_11SessionArgsE": {"registers": 127},
           "_ZN3att25session_decode_fft_kernelILb0ELb1ELb0EEEvNS_11SessionArgsE": {"registers": 64},
           "_Z6kernelILi4ELb0EEvPf": {"registers": 32}}
    d = KR.compare(old, new)
    assert d["same"] == 4 and d["gone"] == []
    assert d["new"] == ["_ZN3att21session_encode_kernelILb0ELb1ELb1ELb1EEEvNS_11SessionArgsE"]
    assert list(d["moved"]) == ["_ZN3att21session_decode_kernelILi1ELb0EEEvNS_11SessionArgsE"]
    # a name the old report holds is its own, whatever its last argument
    assert KR.earlier_name("_ZN3att21session_decode_kernelILi1ELb0EEEvNS_11SessionArgsE", old) == \
        "_ZN3att21session_decode_kernelILi1ELb0EEEvNS_11SessionArgsE"
    # a last argument true is a new instance
    assert KR.earlier_name("_ZN3att25session_decode_fft_kernelILb0ELb1ELb1EEEvNS_11SessionArgsE", old) == \
        "_ZN3att25session_decode_fft_kernelILb0ELb1ELb1EEEvNS_11SessionArgsE"
