"""The streaming decodes on the smooth route's radix-7 instance: P (the random
decode, also the synthesis of N and Q), S (the complex decode) and O's
two-launch projection synthesis, ``csrc/stream_step.cu:
session_decode_fft_kernel<., true, true>`` wherever
``frames_fft.fft_covers_smooth7(n_fft)`` and ``n_fft`` has a factor 7 (n_fft
even, 2^a 3^b 5^c 7^d, 64 to 4096: 896, 1344, 1680, 1764, ...).  On the CPU
the sessions run the kernel's plain version,
``ops/cuda/stream_step.py:_synthesize_fft(..., smooth=True)`` (the
mixed-radix schedule of ``frames_irfft_reference`` with its radix-7 stage,
the session-wide pairs, the overlap-add in class order); ``chip_smoke.py``
holds the kernel to it bit for bit on the card.

* the rule: ``session_route(n, "decode")`` is ``"smooth"`` at every even
  7-smooth shape with a factor 7 the decode gate takes (199), ``"polish"``
  stays ``"product"`` there, no shape the gate took is lost, 1408/352 (2^7
  11) keeps the product route;
* the plans at the radix-7 shapes and O's narrow blocks; the operands;
* P and S at 1344/336 and 896/224 against the JAX package's generic chunk
  scan (it has no session layout at these shapes) with the same draws, 1e-4
  of the largest sample (float32 sums in another order), and against a
  float64 oracle (``np.fft.irfft`` times the synthesis window over the gain,
  overlap-added), 1e-5 (float32 FFT sums);
* P and S at every other overlap the gate takes (2, 5, 6, 7, 8; two sevens
  at 3528) against the oracle under the chain's own gain (the overlap), 1e-5;
* O's synthesis (gain = overlap) at 1344/336 against the oracle, 1e-5, and
  its projection against the float64 analysis of that signal;
* the ``pghi`` session at 1344/336 against the JAX generic scan (spectral
  convergence within ``1.1 s + 1e-3`` of the scan's, ``bench.py:582``, and
  1e-3 of the largest sample: the recurrence's float32 sums in another
  order);
* block by block, the radix-7 schedule gives the whole session bit for bit.
"""
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
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_decode_fft import emulate_blocks
from test_torch_stream_kernel import oracle
from test_torch_streaming import spectral_convergence

SESSION_SHAPES = [(1344, 336), (896, 224)]
# the radix-7 decode at every other overlap its gate takes (2, 5, 6, 7, 8)
OVERLAP_SHAPES = [(4032, 2016), (1680, 336), (1344, 224), (3528, 504), (1344, 168)]
# the framings chip_smoke.py sweeps the plans at (SEVEN_SHAPES)
SEVEN_SHAPES = [(896, 224), (1344, 336), (1792, 448), (1680, 420)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sevens():
    return [n for n in range(64, 4097) if FF.fft_covers_smooth7(n) and not FF.fft_covers_smooth(n)]


def chains(n_fft, hop, mode=None):
    kw = {} if mode is None else {"inversion_mode": mode}
    return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, **kw),
            PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu",
                                                                       **kw))


def session(n_fft, hop, seed):
    """Seeded audio of three chunks of 2 n_fft and its session encode (the
    encode's own radix-7 route), the last chunk of frames ragged (three
    frames short)."""
    chunk = 2 * n_fft
    _, pc = chains(n_fft, hop)
    x = make_audio(seed, batch=2, n=3 * chunk - 500)[:, 0]
    spec, _ = PK.make_fused_forward_session(pc, chunk)(torch.as_tensor(x))
    return x, chunk // hop, spec[:, :-3]


def test_route_rule_at_every_seven_shape():
    """The decodes smooth at all 199 shapes (by n_fft alone), the polish and
    O's two-launch analysis too (the polish where its block holds the grid),
    every shape the decode gate took on the product route still taken,
    1408/352 on the products."""
    n_shapes = 0
    for n in sevens():
        assert PK.session_route(n, "decode") == "smooth" and PK.session_route(n, "polish") == "smooth"
        assert PK.session_route(n, "project") == "smooth"
        for ov in range(2, 9):
            if n % ov or (n // ov) % 4:
                continue
            hop = n // ov
            n_shapes += 1
            assert PK.session_route(n, "decode", hop) == "smooth" and PK.kernel_covers("decode", n, hop)
            if PK._pick_rows("decode", n, hop) is not None:       # the product's gate took it
                assert PK.kernel_covers("decode", n, hop)
            tp = 3 + 16 + ov - 1
            fits = PK._polish_smem_bytes(tp, hop, n, 1, False) <= PK.MAX_SMEM
            assert (PK._polish_plan(n, hop, tp) is not None) == fits
    assert n_shapes == 199
    # 1408 = 2^7 11: the product route for every kind, the plan its height
    assert all(PK.session_route(1408, k, 352) == "product" for k in PK.SESSION_ROUTE_KINDS)
    assert PK._decode_plan(1408, 352) == (PK._pick_rows("decode", 1408, 352), 0)
    assert PK._decode_plan(1408, 352, PK.PROJECT_SYN_ROWS) == (PK.PROJECT_SYN_ROWS, 0)
    # the powers of two and the 5-smooth sizes keep their routes and plans
    assert PK.session_route(1024, "decode") == "fft" and PK._decode_plan(1024, 256) == (56, 4)
    assert PK._decode_plan(1200, 300) == (40, 2) and PK._decode_plan(960, 240) == (24, 4)


def test_plans():
    """The plans of ``frames_fft.class_plan_smooth`` with the radix-7
    instance's blocks an SM (``DECODE_SEVEN_BLOCKS``): on an H100 the fastest
    of a sweep of every plan or close to it (``chip_smoke.py:
    seven_plan_sweep``); O's narrow blocks the smallest multiple of 2
    overlap that holds 8 chunks, with as many FFTs as fit."""
    assert PK.DECODE_SEVEN_BLOCKS == 3
    plans = {s: PK._decode_plan(*s) for s in SEVEN_SHAPES}
    assert plans == {(896, 224): (48, 4), (1344, 336): (40, 2), (1792, 448): (16, 2), (1680, 420): (24, 2)}
    narrow = {s: PK._decode_plan(*s, PK.PROJECT_SYN_ROWS) for s in SEVEN_SHAPES}
    assert narrow == {(896, 224): (8, 4), (1344, 336): (8, 2), (1792, 448): (8, 2), (1680, 420): (8, 2)}
    assert [PK._decode_plan(*s) for s in OVERLAP_SHAPES] == [(12, 1), (30, 2), (60, 2), (56, 1), (48, 2)]
    for n, hop in SEVEN_SHAPES + OVERLAP_SHAPES:
        for rows in (None, PK.PROJECT_SYN_ROWS):
            r, teams = PK._decode_plan(n, hop, rows)
            assert r % (2 * (n // hop)) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
            assert PK._decode_fft_smem_bytes(r, hop, n, teams) <= PK.MAX_SMEM


def test_operands():
    """The window over the gain and n_fft (its 1 / n fold a float64 division
    rounded once) and the twiddle table at 1344; the synthesis basis at
    1408."""
    w = torch.hann_window(1344)
    syn, wsyn, tw = PK._decode_operands(w, 4.0, 1344, 336)
    assert syn is None and wsyn.shape == (1344,) and tw.shape == (2, 1344) and wsyn.dtype == torch.float32
    assert torch.equal(wsyn, FF.irfft_window(w / 4.0, 1344, smooth=True))
    exact = np.float64(t2n(w / 4.0)) / 1344.0
    assert np.array_equal(t2n(wsyn), exact.astype(np.float32))
    assert np.array_equal(t2n(tw), FF.fft_twiddles(1344))
    syn, wsyn, tw = PK._decode_operands(torch.hann_window(1408), 4.0, 1408, 352)
    assert wsyn is None and tw is None and syn.shape[0] == 4
    _, pc = chains(1344, 336)
    assert PK._Session(pc, 8).decode_operands()[0] is None


@pytest.mark.parametrize("n_fft,hop", SESSION_SHAPES)
def test_p_vs_jax_scan_and_oracle(n_fft, hop):
    """P with the JAX generic scan's own draws (``JK._session_angles`` replays
    its key pipeline): the JAX scan at 1e-4, the float64 oracle at 1e-5, the
    session the radix-7 schedule itself."""
    assert PK.session_route(n_fft, "decode") == "smooth" and PK._decode_plan(n_fft, hop)[1] > 0
    jc, pc = chains(n_fft, hop)
    _, T_c, spec = session(n_fft, hop, n_fft + 3)
    mags = spec.abs()
    T, F = mags.shape[1:]
    key = jax.random.PRNGKey(n_fft)
    ang = np.array(JK._session_angles(key, -(-T // T_c), T_c, F, F, (2,)))[..., :F]
    y = PK.make_fused_random_invert(pc, T_c, angles=torch.as_tensor(ang))(mags)
    y_j = JS.scan_invert(jc, jnp.asarray(t2n(mags)), T_c, "random", key=key)
    assert y.shape == y_j.shape == (2, T * hop)
    assert rel(t2n(y), np.array(y_j)) <= 1e-4
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), 4.0, n_fft, hop, T, angles=ang,
                    spec=np.float64(t2n(mags)))
    assert rel(t2n(y), y_o) <= 1e-5
    a = torch.as_tensor(ang)[:, :T]
    assert torch.equal(y, PK._synthesize_fft(mags * torch.cos(a), mags * torch.sin(a), pc[1].inv_window, 4.0,
                                             n_fft, hop, T, smooth=True))


@pytest.mark.parametrize("n_fft,hop", SESSION_SHAPES)
def test_s_vs_jax_scan_and_oracle(n_fft, hop):
    """S with imaginary parts at DC and nyquist, which neither route reads:
    the JAX scan (on the spectrum without them) at 1e-4, the oracle at
    1e-5."""
    jc, pc = chains(n_fft, hop)
    _, T_c, spec = session(n_fft, hop, n_fft + 4)
    clean = t2n(spec).copy()
    clean[..., 0] = clean[..., 0].real
    clean[..., -1] = clean[..., -1].real
    spec[..., 0] = spec[..., 0] + 0.5j
    spec[..., -1] = spec[..., -1] - 0.25j
    T = spec.shape[1]
    y = PK.make_fused_complex_invert(pc, T_c)(spec)
    y_j = JS.scan_invert(jc, jnp.asarray(clean), T_c)
    assert y.shape == y_j.shape == (2, T * hop)
    assert rel(t2n(y), np.array(y_j)) <= 1e-4
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), 4.0, n_fft, hop, T, spec=np.complex128(clean))
    assert rel(t2n(y), y_o) <= 1e-5


@pytest.mark.parametrize("n_fft,hop", OVERLAP_SHAPES)
def test_p_and_s_at_other_overlaps_vs_oracle(n_fft, hop):
    """P and S through the sessions at overlap 2, 5, 6, 7 and 8 under the
    chain's own gain (the overlap) against the float64 oracle, 1e-5."""
    ov, F = n_fft // hop, n_fft // 2 + 1
    _, pc = chains(n_fft, hop)
    gain = float(pc[0].gain_compensation)
    assert gain == ov and PK.session_route(n_fft, "decode") == "smooth"
    rng = np.random.default_rng(n_fft + hop)
    T_c, T = 2 * ov, 5 * ov + 3
    mag = np.abs(rng.standard_normal((2, T, F))).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (2, -(-T // T_c) * T_c, F)).astype(np.float32)
    y = PK.make_fused_random_invert(pc, T_c, angles=torch.as_tensor(ang))(torch.as_tensor(mag))
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), gain, n_fft, hop, T, angles=ang, spec=np.float64(mag))
    assert y.shape == (2, T * hop) and rel(t2n(y), y_o) <= 1e-5
    spec = mag * np.exp(1j * ang[:, :T])
    s = PK.make_fused_complex_invert(pc, T_c)(torch.as_tensor(spec.astype(np.complex64)))
    _, s_o = oracle(None, None, t2n(pc[1].inv_window), gain, n_fft, hop, T,
                    spec=np.complex128(spec.astype(np.complex64)))
    assert s.shape == (2, T * hop) and rel(t2n(s), s_o) <= 1e-5


def test_projection_synthesis_vs_oracle():
    """O's projection at 1344/336 (the polish's radix-7 instance, and the
    two-launch projection's where the polish cannot hold the grid): its
    synthesis (gain = overlap) of a grid with unwrapped phases and its
    overlap - 1 zero frames, the radix-7 schedule, against the float64
    oracle at 1e-5; the whole projection (``gl_project_reference``) against
    the float64 analysis of the oracle's signal, ``|X| (cos, sin)`` of the
    phases within 1e-5 of the largest magnitude, the pinned, frozen and zero
    rows as they were."""
    n_fft, hop = 1344, 336
    ov, F = n_fft // hop, n_fft // 2 + 1
    rng = np.random.default_rng(13)
    ctx, T_c = 3, 8
    Tp = ctx + T_c + ov - 1
    mag = np.abs(rng.standard_normal((2, Tp, F))).astype(np.float32)
    mag[:, -(ov - 1):] = 0.0
    ph = rng.uniform(-50.0, 50.0, (2, Tp, F)).astype(np.float32)
    _, pc = chains(n_fft, hop, "pghi_gl")
    inv_w, win = pc[1].inv_window, pc[1].window
    m_t, p_t = torch.as_tensor(mag), torch.as_tensor(ph)
    y = PK._synthesis_reference(m_t * torch.cos(p_t), m_t * torch.sin(p_t), inv_w, float(ov), n_fft, hop, Tp)
    assert torch.equal(y, PK._synthesize_fft(m_t * torch.cos(p_t), m_t * torch.sin(p_t), inv_w, float(ov), n_fft,
                                             hop, Tp, smooth=True))
    _, y_o = oracle(None, None, t2n(inv_w), float(ov), n_fft, hop, Tp,
                    spec=np.float64(mag) * np.exp(1j * np.float64(ph)))
    assert rel(t2n(y), y_o) <= 1e-5
    lo, hi = pc[1].gl_frozen(T_c)
    got = t2n(PK.gl_project_reference(m_t, p_t, inv_w, win, n_fft, hop, ctx, lo, hi))
    Tx = Tp - (ov - 1)
    fr = np.stack([y_o[:, i * hop: i * hop + n_fft] for i in range(Tx)], axis=1)
    new = np.angle(np.fft.rfft(fr * np.float64(t2n(win)), axis=-1))
    rows = np.arange(Tx)
    upd = ((rows >= ctx) & ((rows < lo) | (rows >= hi)))[None, :, None]
    ref = np.where(upd, new, ph[:, :Tx])
    m = mag[:, :Tx]
    unit = lambda p: np.stack([m * np.cos(p), m * np.sin(p)])  # noqa: E731
    assert np.abs(unit(got[:, :Tx]) - unit(ref)).max() <= 1e-5 * mag.max()
    assert np.array_equal(got[:, :ctx], ph[:, :ctx]) and np.array_equal(got[:, lo:hi], ph[:, lo:hi])
    assert np.array_equal(got[:, Tx:], ph[:, Tx:])


def test_pghi_session_synthesis_vs_jax_scan():
    """The ``pghi`` decode at 1344/336 (the recurrence, then P's radix-7
    synthesis) against the JAX generic scan, the silent bins' angles from the
    same key on both sides."""
    n_fft, hop = 1344, 336
    jc, pc = chains(n_fft, hop, "pghi")
    x, T_c, spec = session(n_fft, hop, 23)
    mags = spec.abs()
    T, F = mags.shape[1:]
    key = jax.random.PRNGKey(6)
    ang = np.array(JK._session_angles(key, -(-T // T_c), T_c, F, F, (2,)))[..., :F]
    y = PK.make_fused_pghi_invert(pc, T_c, angles=torch.as_tensor(ang))(mags)
    y_j = np.array(JS.scan_invert(jc, jnp.asarray(t2n(mags)), T_c, "pghi", key=key))
    assert y.shape == y_j.shape == (2, T * hop) and np.isfinite(t2n(y)).all()
    assert rel(t2n(y), y_j) <= 1e-3
    d = n_fft - hop
    s_p = spectral_convergence(t2n(y)[:, d:], x, n_fft, hop)
    s_j = spectral_convergence(y_j[:, d:], x, n_fft, hop)
    assert s_p <= 1.1 * s_j + 1e-3, (s_p, s_j)


def test_blocks_of_the_seven_plan_give_the_session():
    """Block by block at the plan's heights at 1344/336 (P and S's, O's
    narrow one), the radix-7 schedule gives the whole session's plain version
    bit for bit; blocks of overlap chunks would pair other frames and not
    round alike."""
    n_fft, hop = 1344, 336
    ov, F = n_fft // hop, n_fft // 2 + 1
    rng = np.random.default_rng(17)
    T = 6 * ov + 3
    mag = torch.as_tensor(np.abs(rng.standard_normal((2, T, F))).astype(np.float32))
    ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, (2, T, F)).astype(np.float32))
    inv_w = torch.hann_window(n_fft)
    whole = PK.session_decode_reference(mag, ang, inv_w, 4.0, n_fft, hop)
    re, im = mag * torch.cos(ang), mag * torch.sin(ang)
    wsyn = FF.irfft_window(inv_w / 4.0, n_fft, smooth=True)
    heights = {PK._decode_plan(n_fft, hop)[0], PK._decode_plan(n_fft, hop, PK.PROJECT_SYN_ROWS)[0]}
    assert heights == {40, 8}
    for rows in sorted(heights):
        assert torch.equal(emulate_blocks(re, im, wsyn, n_fft, hop, rows, smooth=True), whole)
    odd = emulate_blocks(re, im, wsyn, n_fft, hop, ov, smooth=True)
    assert not torch.equal(odd, whole) and rel(t2n(odd), t2n(whole)) <= 1e-5


def test_product_route_at_1408_and_no_route_counted_on_the_cpu():
    """P at 1408/352 (2^7 11) keeps the window-folded synthesis product
    (``_synthesize``) within 1e-5 of the oracle; on the CPU the decodes at
    1344/336 and 1408/352 launch and count nothing."""
    n_fft, hop = 1408, 352
    F = n_fft // 2 + 1
    rng = np.random.default_rng(19)
    mag = torch.as_tensor(np.abs(rng.standard_normal((2, 11, F))).astype(np.float32))
    ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, (2, 11, F)).astype(np.float32))
    inv_w = torch.hann_window(n_fft)
    y = PK.session_decode_reference(mag, ang, inv_w, 4.0, n_fft, hop)
    assert torch.equal(y, PK._synthesize(mag * torch.cos(ang), mag * torch.sin(ang), inv_w, 4.0, n_fft, hop, 11))
    _, y_o = oracle(None, None, t2n(inv_w), 4.0, n_fft, hop, 11, angles=t2n(ang), spec=np.float64(t2n(mag)))
    assert rel(t2n(y), y_o) <= 1e-5
    PK.reset_launches()
    for n, h in ((1344, 336), (1408, 352)):
        _, pc = chains(n, h, "pghi")
        mags = torch.rand(2, 20, n // 2 + 1)
        PK.make_fused_random_invert(pc, 8, generator=torch.Generator().manual_seed(0))(mags)
        PK.make_fused_complex_invert(pc, 8)(torch.polar(mags, mags))
        PK.make_fused_pghi_invert(pc, 8, generator=torch.Generator().manual_seed(1))(mags)
    assert not any(PK.launches.values()) and not any(PK.routes.values())
