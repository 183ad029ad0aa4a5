"""The streaming decodes on the smooth route: P (the random decode, also the
synthesis of N and Q), S (the complex decode) and O's two-launch projection
synthesis, ``csrc/stream_step.cu:session_decode_fft_kernel<., true>`` where
``frames_fft.fft_covers_smooth(n_fft)`` (n_fft even, 2^a 3^b 5^c, 64 to
4096, no power of two).  On the CPU the sessions run the kernel's plain
version, ``ops/cuda/stream_step.py:_synthesize_fft(..., smooth=True)`` (the
mixed-radix schedule of ``frames_irfft_reference``, the session-wide pairs,
the overlap-add in class order); ``chip_smoke.py`` holds the kernel to it
bit for bit on the card.

Tolerances, and why:

* against the JAX package's generic chunk scans (it has no session layout
  at these shapes) with the same draws: 1e-4 of the largest sample (float32
  sums in another order, as ``tests/test_torch_frames_fft_smooth.py`` holds
  L and M);
* against a float64 oracle (``np.fft.irfft``, an explicit overlap-add) and
  against the JAX package's own projection synthesis: 1e-5 (float32 FFT
  sums);
* the ``pghi`` session's audio against the JAX generic scan's, RT-PGHI
  phases from the same draws: spectral convergence (against the encoded
  audio) within ``1.1 s + 1e-3`` of the scan's (``bench.py:582``), and 1e-3
  of the largest sample (the recurrence's float32 sums in another order);
* block by block, the smooth schedule gives the whole session bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu import streaming as JS
from acids_transforms_tpu.ops.fft import irfft_frames as j_irfft
from acids_transforms_tpu.ops.framing import overlap_add as j_ola
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_decode_fft import emulate_blocks
from test_torch_stream_kernel import oracle
from test_torch_streaming import spectral_convergence

SHAPES = [(1200, 300), (960, 240), (240, 60)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chains(n_fft, hop, mode=None):
    kw = {} if mode is None else {"inversion_mode": mode}
    return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, **kw),
            PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu",
                                                                       **kw))


def session(n_fft, hop, seed):
    """Seeded audio of three chunks of 2 n_fft and its session encode, the
    last chunk of frames ragged (three frames short)."""
    chunk = 2 * n_fft
    _, pc = chains(n_fft, hop)
    x = make_audio(seed, batch=2, n=3 * chunk - 500)[:, 0]
    spec, _ = PK.make_fused_forward_session(pc, chunk)(torch.as_tensor(x))
    return x, chunk // hop, spec[:, :-3]


@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_p_vs_jax_scan_and_oracle(n_fft, hop):
    """P with the JAX generic scan's own draws (``JK._session_angles`` replays
    its key pipeline): the JAX scan at 1e-4, the float64 oracle at 1e-5."""
    assert PK.session_route(n_fft, "decode") == "smooth" and PK._decode_plan(n_fft, hop)[1] > 0
    jc, pc = chains(n_fft, hop)
    _, T_c, spec = session(n_fft, hop, n_fft + 3)
    mags = spec.abs()
    T, F = mags.shape[1:]
    key = jax.random.PRNGKey(n_fft)
    n_chunks = -(-T // T_c)
    ang = np.array(JK._session_angles(key, n_chunks, T_c, F, F, (2,)))[..., :F]
    y = PK.make_fused_random_invert(pc, T_c, angles=torch.as_tensor(ang))(mags)
    y_j = JS.scan_invert(jc, jnp.asarray(t2n(mags)), T_c, "random", key=key)
    assert y.shape == y_j.shape == (2, T * hop)
    assert rel(t2n(y), np.array(y_j)) <= 1e-4
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), 4.0, n_fft, hop, T, angles=ang,
                    spec=np.float64(t2n(mags)))
    assert rel(t2n(y), y_o) <= 1e-5
    assert torch.equal(y, PK.session_decode_reference(mags, torch.as_tensor(ang), pc[1].inv_window, 4.0, n_fft,
                                                      hop))


@pytest.mark.parametrize("n_fft,hop", SHAPES)
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


def test_pghi_session_synthesis_vs_jax_scan():
    """The ``pghi`` decode at 1200/300 (the recurrence, then P's smooth
    synthesis) against the JAX generic scan, the silent bins' angles from
    the same key on both sides."""
    n_fft, hop = 1200, 300
    jc, pc = chains(n_fft, hop, "pghi")
    x, T_c, spec = session(n_fft, hop, 21)
    mags = spec.abs()
    T, F = mags.shape[1:]
    key = jax.random.PRNGKey(5)
    ang = np.array(JK._session_angles(key, -(-T // T_c), T_c, F, F, (2,)))[..., :F]
    y = PK.make_fused_pghi_invert(pc, T_c, angles=torch.as_tensor(ang))(mags)
    y_j = np.array(JS.scan_invert(jc, jnp.asarray(t2n(mags)), T_c, "pghi", key=key))
    assert y.shape == y_j.shape == (2, T * hop) and np.isfinite(t2n(y)).all()
    assert rel(t2n(y), y_j) <= 1e-3
    d = n_fft - hop
    s_p = spectral_convergence(t2n(y)[:, d:], x, n_fft, hop)
    s_j = spectral_convergence(y_j[:, d:], x, n_fft, hop)
    assert s_p <= 1.1 * s_j + 1e-3, (s_p, s_j)


def test_projection_synthesis_vs_jax_and_oracle():
    """O's projection at 1200/300 on the smooth route: its synthesis (gain
    = overlap) of a grid with unwrapped phases and its overlap - 1 zero
    frames against the JAX package's own projection synthesis
    (``pghi_gl_stream``'s irfft, overlap-add, / overlap) and the float64
    oracle at 1e-5; the whole projection (``gl_project_reference``) against
    the JAX package's projection on the grid's bins, ``|X| (cos, sin)`` of
    the phases within 1e-5 of the largest magnitude."""
    n_fft, hop = 1200, 300
    ov, F = n_fft // hop, n_fft // 2 + 1
    rng = np.random.default_rng(7)
    ctx, T_c = 3, 8
    Tp = ctx + T_c + ov - 1
    mag = np.abs(rng.standard_normal((2, Tp, F))).astype(np.float32)
    mag[:, -(ov - 1):] = 0.0
    ph = rng.uniform(-50.0, 50.0, (2, Tp, F)).astype(np.float32)
    jc, pc = chains(n_fft, hop, "pghi_gl")
    inv_w, win = pc[1].inv_window, pc[1].window
    m_t, p_t = torch.as_tensor(mag), torch.as_tensor(ph)
    y = PK._synthesis_reference(m_t * torch.cos(p_t), m_t * torch.sin(p_t), inv_w, float(ov), n_fft, hop, Tp)
    assert torch.equal(y, PK._synthesize_fft(m_t * torch.cos(p_t), m_t * torch.sin(p_t), inv_w, float(ov), n_fft,
                                             hop, Tp, smooth=True))
    spec = jnp.asarray(mag) * jnp.exp(1j * jnp.asarray(ph))
    y_j = np.array(j_ola(j_irfft(spec, n_fft=n_fft) * jnp.asarray(t2n(inv_w)), hop) / ov)[..., : Tp * hop]
    assert rel(t2n(y), y_j) <= 1e-5
    _, y_o = oracle(None, None, t2n(inv_w), float(ov), n_fft, hop, Tp,
                    spec=np.float64(mag) * np.exp(1j * np.float64(ph)))
    assert rel(t2n(y), y_o) <= 1e-5
    lo, hi = pc[1].gl_frozen(T_c)
    got = t2n(PK.gl_project_reference(m_t, p_t, inv_w, win, n_fft, hop, ctx, lo, hi))
    Tx = Tp - (ov - 1)
    fr = np.stack([y_j[:, i * hop: i * hop + n_fft] for i in range(Tx)], axis=1)
    new = np.angle(np.fft.rfft(np.float64(fr) * np.float64(t2n(win)), axis=-1))
    rows = np.arange(Tx)
    upd = ((rows >= ctx) & ((rows < lo) | (rows >= hi)))[None, :, None]
    ref = np.where(upd, new, ph[:, :Tx])
    m = mag[:, :Tx]
    unit = lambda p: np.stack([m * np.cos(p), m * np.sin(p)])  # noqa: E731
    assert np.abs(unit(got[:, :Tx]) - unit(ref)).max() <= 1e-5 * mag.max()
    assert np.array_equal(got[:, :ctx], ph[:, :ctx]) and np.array_equal(got[:, lo:hi], ph[:, lo:hi])
    assert np.array_equal(got[:, Tx:], ph[:, Tx:])


@pytest.mark.parametrize("n_fft,hop", [(1200, 300), (240, 60)])
def test_blocks_of_the_smooth_plan_give_the_session(n_fft, hop):
    """Block by block at the smooth plan's heights (P and S's, O's narrow
    one), the mixed-radix schedule gives the whole session's plain version
    bit for bit; blocks of overlap chunks would pair other frames and not
    round alike."""
    ov, F = n_fft // hop, n_fft // 2 + 1
    rng = np.random.default_rng(11)
    T = 6 * ov + 3
    mag = torch.as_tensor(np.abs(rng.standard_normal((2, T, F))).astype(np.float32))
    ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, (2, T, F)).astype(np.float32))
    inv_w = torch.hann_window(n_fft)
    whole = PK.session_decode_reference(mag, ang, inv_w, 2.0, n_fft, hop)
    re, im = mag * torch.cos(ang), mag * torch.sin(ang)
    wsyn = FF.irfft_window(inv_w / 2.0, n_fft, smooth=True)
    heights = {PK._decode_plan(n_fft, hop)[0], PK._decode_plan(n_fft, hop, PK.PROJECT_SYN_ROWS)[0]}
    assert all(r % (2 * ov) == 0 for r in heights)
    for rows in sorted(heights):
        assert torch.equal(emulate_blocks(re, im, wsyn, n_fft, hop, rows, smooth=True), whole)
    odd = emulate_blocks(re, im, wsyn, n_fft, hop, ov, smooth=True)
    assert not torch.equal(odd, whole) and rel(t2n(odd), t2n(whole)) <= 1e-5


def test_routes_plans_and_operands():
    """The decodes take the smooth route at the even 5-smooth sizes (the
    plans a sweep of every plan on an H100 found fastest), the FFT route at
    the powers of two, the product route at 1408/352 (1344/336 takes the
    radix-7 instance); the operands follow the route; nothing launches or
    counts on the CPU."""
    assert PK._decode_plan(1200, 300) == (40, 2) and PK._decode_plan(960, 240) == (24, 4)
    assert PK._decode_plan(768, 192) == (24, 4) and PK._decode_plan(400, 100) == (48, 8)
    assert PK._decode_plan(1920, 480) == (16, 2)
    assert PK._decode_plan(1200, 300, PK.PROJECT_SYN_ROWS) == (8, 2)
    assert PK._decode_plan(1024, 256) == (56, 4) and PK._decode_plan(1408, 352)[1] == 0
    assert PK._decode_plan(1344, 336)[1] > 0
    syn, wsyn, tw = PK._decode_operands(torch.hann_window(1200), 4.0, 1200, 300)
    assert syn is None and tw.shape == (2, 1200)
    assert torch.equal(wsyn, FF.irfft_window(torch.hann_window(1200) / 4.0, 1200, smooth=True))
    _, pc = chains(1200, 300, "pghi")
    PK.reset_launches()
    mags = torch.rand(2, 20, 601)
    PK.make_fused_random_invert(pc, 8, generator=torch.Generator().manual_seed(0))(mags)
    PK.make_fused_complex_invert(pc, 8)(torch.polar(mags, mags))
    PK.make_fused_pghi_invert(pc, 8, generator=torch.Generator().manual_seed(1))(mags)
    assert not any(PK.launches.values()) and not any(PK.routes.values())
