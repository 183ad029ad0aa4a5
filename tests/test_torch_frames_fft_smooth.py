"""The mixed-radix (smooth) route of R, N's magnitude encode, L, M and the
decodes (P, S, O's projection synthesis; their sessions in
``tests/test_torch_stream_decode_smooth.py``):
``ops/cuda/frames_fft.py`` (``fft_covers_smooth``, ``fft_radices``, the
``smooth=True`` schedule of ``frames_rfft_reference`` /
``frames_irfft_reference``) and the session wrappers that pick it.

* the rule: the exact list of sizes it takes, ``fft_covers`` unchanged, the
  radix plan, the team and its buffer, the twiddle table, the
  butterfly constants shared with ``csrc/fft_smem.cuh``;
* the plain schedule against a float64 ``np.fft`` oracle and against the DFT
  products, within 1e-5 of the largest value, at sizes from 96 to 4000 under
  hann and the DGT's gaussian, with an odd frame count;
* the plain R, N's encode, L and M at 1200/300 and 960/240 (the route's
  sessions on the CPU) against the JAX package's generic chunk scan (it has
  no session layout at these shapes) within 1e-4 of the largest value, as
  ``tests/test_torch_stream_kernel.py`` holds them, and against the float64
  session oracle within 1e-5;
* the route rule: R, L and the decodes smooth at 1200/300, the polish and
  the other kernels on their product routes there, the products at 1408/352
  (2^7 11; at 1344/336, 2^6 3 7, R and L take the radix-7 stage,
  ``tests/test_torch_frames_fft_seven.py``, the decodes the products), and
  every shape the encode, roundtrip and decode gates took before still
  taken.

On the card ``chip_smoke.py`` holds the kernels against these plain versions
(bit-identical at 1200/300, 960/240, 768/192, 400/100 and 1920/480).
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
from acids_transforms_tpu_torch.ops.cuda import spectral as SP
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.fft import _dft_matrices
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window
from acids_transforms_tpu_torch.tools.fft_bank_conflicts import stage_conflicts
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_kernel import oracle as session_oracle

SIZES = [96, 120, 160, 240, 400, 480, 768, 960, 1200, 1920, 2400, 4000]
SESSION_SHAPES = [(1200, 300), (960, 240)]
HEADER = os.path.join(os.path.dirname(PK.__file__), "..", "..", "csrc", "fft_smem.cuh")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def window(name, n):
    return gaussian_dgt_window(n) if name == "gaussian" else get_window("hann", n)


def test_rule_takes_the_even_5_smooth_sizes():
    smooth = sorted({2 ** a * 3 ** b * 5 ** c for a in range(1, 13) for b in range(8) for c in range(6)})
    expect = [n for n in smooth if 64 <= n <= 4096 and n & (n - 1)]
    assert [n for n in range(16, 9000) if FF.fft_covers_smooth(n)] == expect
    assert 1200 in expect and 960 in expect and 768 in expect and 1344 not in expect and 1056 not in expect
    # the power-of-two rule is as it was
    assert [n for n in range(16, 9000) if FF.fft_covers(n)] == [64, 128, 256, 512, 1024, 2048, 4096]
    assert not any(FF.fft_covers(n) and FF.fft_covers_smooth(n) for n in range(16, 9000))


def test_radix_plan_team_and_table():
    for n in [n for n in range(64, 4097) if FF.fft_covers_smooth(n)] + [64, 1024, 2048]:
        rad = FF.fft_radices(n)
        assert math.prod(rad) == n and list(rad) == sorted(rad, key=[5, 3, 4, 2].index)
        assert rad.count(2) <= 1 and rad[-1] in (2, 4)
        if not FF.fft_covers(n):
            g = FF.fft_smooth_team_threads(n)
            assert g & (g - 1) == 0 and 8 < n / g <= 16 and g <= 256
            assert FF.fft_smooth_max_teams(n) == 256 // g
            s, need = 1, 0
            for r in rad[:-1]:
                need = max(need, (r - 1) * (n // r - 1 - (n // r - 1) % s))
                s *= r
            assert FF.fft_smooth_table(n) == need + 1 <= n
            buf = FF.fft_smooth_buf_floats(n)
            assert buf >= 4 * n and buf % 4 == 0 and (g >= 32 or buf % 32 == g)
    assert FF.fft_radices(1200) == (5, 5, 3, 4, 4) and FF.fft_radices(1920) == (5, 3, 4, 4, 4, 2)
    assert FF.fft_radices(1024) == (4, 4, 4, 4, 4) and FF.fft_radices(2048)[-1] == 2
    assert FF.fft_smooth_team_threads(1200) == 128 and FF.fft_smooth_table(1200) == 957
    with pytest.raises(ValueError):
        FF.fft_radices(1408)                                # 2^7 11
    assert FF.fft_radices(1344) == (7, 3, 4, 4, 4)          # 2^6 3 7: the radix-7 stage first


def test_header_holds_the_same_constants():
    text = open(HEADER).read()
    names = {"kR3S": "r3s", "kR5C1": "r5c1", "kR5C2": "r5c2", "kR5S1": "r5s1", "kR5S2": "r5s2"}
    for cname, key in names.items():
        m = re.search(r"constexpr float %s = (-?0x[0-9a-fp.+-]+)f;" % cname, text)
        assert m and float.fromhex(m.group(1)) == FF.SMOOTH_CONSTANTS[key], cname


@pytest.mark.parametrize("wname", ["hann", "gaussian"])
@pytest.mark.parametrize("n", SIZES)
def test_smooth_schedule_vs_float64_oracle_and_product(n, wname):
    rng = np.random.default_rng(n)
    frames = rng.standard_normal((2, 5, n)).astype(np.float32)   # 5 frames: the last pairs with zeros
    frames[1, 2] *= 1e-3
    w = window(wname, n)
    re, im = FF.frames_rfft_reference(torch.as_tensor(frames), w, smooth=True)
    assert re.shape == im.shape == (2, 5, n // 2 + 1) and re.dtype == torch.float32
    got = t2n(re).astype(np.float64) + 1j * t2n(im)
    ora = np.fft.rfft(np.float64(frames) * np.float64(t2n(w)), axis=-1)
    assert rel(got, ora) <= 1e-5
    C, S = (torch.as_tensor(m) for m in _dft_matrices(n))
    wf = torch.as_tensor(frames) * w
    assert rel(t2n(re), t2n(torch.matmul(wf, C))) <= 1e-5
    assert rel(t2n(im), t2n(torch.matmul(wf, S))) <= 1e-5
    # pairs (r, r + 2) give the same spectra, and the inverse of them is the frames
    re2, im2 = FF.frames_rfft_reference(torch.as_tensor(frames), w, stride=2, smooth=True)
    assert rel(t2n(re2) + 1j * t2n(im2), ora) <= 1e-5
    wsyn = FF.irfft_window(w, n, smooth=True)
    y = FF.frames_irfft_reference(re, im, wsyn, stride=2, smooth=True)
    y_o = np.fft.irfft(ora, n=n, axis=-1) * np.float64(t2n(w))      # irfft_window folds the 1 / n
    assert y.shape == (2, 5, n) and rel(t2n(y), y_o) <= 1e-5


def test_smooth_schedule_refuses_other_sizes():
    for n in (64, 1024, 1408, 1056, 8000):
        assert not FF.fft_covers_smooth(n)
        with pytest.raises(ValueError, match="2\\^a 3\\^b 5\\^c"):
            FF.frames_rfft_reference(torch.zeros(1, 2, n), torch.ones(n), smooth=True)
    # 1344 = 2^6 3 7: not 5-smooth, but the schedule's radix-7 stage takes it
    assert not FF.fft_covers_smooth(1344) and FF.fft_covers_smooth7(1344)
    assert FF.frames_rfft_reference(torch.zeros(1, 2, 1344), torch.ones(1344), smooth=True)[0].shape == (1, 2, 673)
    with pytest.raises(ValueError, match="power of two"):
        FF.frames_rfft_reference(torch.zeros(1, 2, 1200), torch.ones(1200))


def test_irfft_window_rounds_the_fold_once():
    w = torch.hann_window(1200) / 3.0
    got = FF.irfft_window(w, 1200, smooth=True)
    assert torch.equal(got, (w.double() / 1200).float())
    assert not torch.equal(got, w * (1.0 / 1200))          # float32 1 / 1200 rounds twice
    w2 = torch.hann_window(1024) / 3.0                       # powers of two: exact either way
    assert torch.equal(FF.irfft_window(w2, 1024), FF.irfft_window(w2, 1024, smooth=True))


def _session(n, hop, seed):
    chunk = 2 * n
    x = make_audio(seed, batch=2, n=3 * chunk - 500)[:, 0]          # a ragged last chunk
    jc = JT.OverlapAdd(n, hop) + JT.RealtimeSTFT(n_fft=n, hop_length=hop)
    pc = PT.OverlapAdd(n, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    assert all(PK.session_route(n, k, hop) == "smooth" for k in PK.SESSION_ROUTE_KINDS)
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


def test_route_rule():
    """R, L, the decodes and O's polish smooth at 1200/300 and 960/240; the
    full-K kernels but E and F keep ``fft_covers`` (E and F take the smooth
    route too); 1408/352 on the products (1344/336's R, L and decodes take
    the radix-7 stage)."""
    for n, hop in SESSION_SHAPES + [(768, 192), (400, 100), (1920, 480)]:
        assert all(PK.session_route(n, k, hop) == "smooth" for k in PK.SESSION_ROUTE_KINDS)
        assert PK._encode_plan(n, hop)[1] > 0 and PK._roundtrip_plan(n, hop)[1] > 0
        assert PK._decode_plan(n, hop)[1] > 0 and PK._decode_plan(n, hop, PK.PROJECT_SYN_ROWS)[1] > 0
        assert PK._polish_plan(n, hop, 20) is not None
    assert SP._kernel_plan(768, 192, None)[1] > 0 and SP._kernel_plan(1920, 480, None)[1] > 0      # E and F
    assert SP._kernel_plan(896, 224, None)[1] > 0                       # 2^7 7: E and F's radix-7 instance
    assert SP._kernel_plan(1408, 352, None)[1] == 0                     # 2^7 11: E and F's product route
    assert PK._encode_plan(1200, 300) == (16, 2) and PK._roundtrip_plan(1200, 300) == (16, 2)
    # the plans a sweep of every plan on the H100 found fastest (frames_fft.class_plan_smooth)
    assert PK._roundtrip_plan(960, 240) == (56, 4) and PK._roundtrip_plan(1920, 480) == (24, 2)
    assert PK._roundtrip_plan(768, 192) == (24, 4) and PK._roundtrip_plan(400, 100) == (56, 8)
    assert PK._encode_plan(1920, 480) == (8, 2)
    assert PK._decode_plan(1408, 352) == (PK._pick_rows("decode", 1408, 352), 0)
    assert PK.session_route(1408, "decode") == "product"
    assert PK.session_route(1344, "decode") == "smooth" and PK._decode_plan(1344, 336)[1] > 0
    assert PK._encode_plan(1408, 352) == (PK._pick_rows("encode", 1408, 352), 0)
    assert PK._roundtrip_plan(1408, 352) == (PK._pick_rows("roundtrip", 1408, 352), 0)
    # 1344/336: R and L on the smooth route's radix-7 instance
    assert PK._encode_plan(1344, 336)[1] > 0 and PK._roundtrip_plan(1344, 336)[1] > 0
    assert PK.session_route(1024, "encode") == "fft" and PK._encode_plan(1024, 256) == (32, 4)
    assert PK._roundtrip_plan(1024, 256) == (24, 4)
    # operands: the window and the twiddles on the smooth route, the bases on the product
    win, tw = PK._encode_operands(torch.hann_window(1200), 1200)
    assert win.shape == (1200,) and tw.shape == (2, 1200)
    wc, ws = PK._encode_operands(torch.hann_window(1408), 1408)
    assert wc.shape == ws.shape == (1408, 705)
    win, tw = PK._encode_operands(torch.hann_window(1344), 1344)
    assert win.shape == (1344,) and tw.shape == (2, 1344)


def test_every_shape_taken_before_is_still_taken():
    for n in range(64, 4097, 4):
        for ov in range(2, 9):
            if n % ov or (n // ov) % 4:
                continue
            hop = n // ov
            old_encode = PK._pick_rows("encode", n, hop) is not None
            old_roundtrip = PK._pick_rows("roundtrip", n, hop) is not None
            if old_encode:
                assert PK.kernel_covers("encode", n, hop), (n, hop)
                rows, teams = PK._encode_plan(n, hop)
                if PK.session_route(n, "encode") == "smooth":
                    assert rows % 2 == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
                    assert PK._encode_fft_smem_bytes(rows, hop, n, teams) <= PK.MAX_SMEM
            if old_roundtrip and PK.session_route(n, "roundtrip", hop) == "smooth":
                assert PK.kernel_covers("roundtrip", n, hop), (n, hop)
                rows, teams = PK._roundtrip_plan(n, hop)
                assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
                assert PK._roundtrip_fft_smem_bytes(rows, ov, hop, teams) <= PK.MAX_SMEM
            if PK._pick_rows("decode", n, hop) is not None:
                assert PK.kernel_covers("decode", n, hop), (n, hop)
                for narrow in (None, PK.PROJECT_SYN_ROWS):
                    rows, teams = PK._decode_plan(n, hop, narrow)
                    if PK.session_route(n, "decode") == "smooth":
                        assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n), (n, hop)
                        assert PK._decode_fft_smem_bytes(rows, hop, n, teams) <= PK.MAX_SMEM


def test_no_route_counted_on_the_cpu():
    n, hop = 1200, 300
    pc = PT.OverlapAdd(n, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    PK.reset_launches()
    x = torch.as_tensor(make_audio(9, batch=2, n=5000)[:, 0])
    PK.make_fused_forward_session(pc, 2400)(x)
    PK.make_fused_roundtrip(pc, 2400)(x)
    assert not any(PK.routes.values()) and not any(PK.launches.values())
    assert {"session_encode:smooth", "session_magnitude:smooth", "session_roundtrip:smooth",
            "session_random_roundtrip:smooth", "session_random_decode:smooth", "session_complex_decode:smooth",
            "gl_project_synthesis:smooth"} <= set(PK.routes)
    assert "gl_polish:smooth" in PK.routes


def test_bank_conflicts_of_the_stages():
    """Counted from the address pattern: every read conflict-free, the writes
    at most 3-way (the radix-3 stage), the stride-1 writes of the odd
    radices conflict-free (the radix-7 stage's too, at 896 and 1344)."""
    for n in (1200, 960, 768, 400, 1920, 96, 896, 1344):
        rows = stage_conflicts(n)
        assert [r["radix"] for r in rows] == list(FF.fft_radices(n))
        assert all(r["read_max"] == 1 for r in rows) and all(r["write_max"] <= 3 for r in rows)
        assert rows[0]["write_max"] == 1 and rows[-1]["write_max"] == 1
