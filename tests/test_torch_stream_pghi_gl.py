"""The streaming ``pghi_gl`` path of the port (``RealtimeSTFT`` /
``RealtimeDGT`` in mode ``pghi_gl``: the RT-PGHI seed polished by
``gl_iterations`` pinned-context Griffin-Lim projections, with and without
lookahead; ``streaming.scan_roundtrip`` / ``scan_invert`` with
``inversion_mode="pghi_gl"``; session O of ``ops/cuda/stream_step.py``, its
seeded recurrence and its projection) against the JAX package on the same
numpy inputs, at n_fft 512/128 with chunks of 1024 samples (8 frames), two
sessions of four chunks with a ragged tail, and 4 Griffin-Lim iterations.
The eager steps and the carried state are in
``test_torch_stream_pghi_gl_state.py``.

Tolerances, and why:

* the projection's plain version against the JAX package's projection on one
  grid: ``|X| (cos, sin)(phase)`` within 1e-4 of the largest ``|X|``;
* the plain session against the JAX Pallas kernel in interpret mode: within
  1e-3 of the largest value, the JAX kernel's own bound against its scan
  (its projections are bf16x3 products);
* the session route against the port's own generic scan with a generator in
  the same state: equal lengths and spectral convergence within ``1.1 s +
  1e-3`` of the scan's (``bench.py:582, 664``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.fft import irfft_frames as j_irfft, rfft_frames as j_rfft
from acids_transforms_tpu.ops.framing import frame as j_frame, overlap_add as j_ola
from acids_transforms_tpu.ops.pghi import pghi_scan as j_pghi_scan
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from test_torch_common import make_audio, rel, t2n, tones
from test_torch_streaming import spectral_convergence

N_FFT, HOP, CHUNK, ITERS = 512, 128, 1024, 4
T_C = CHUNK // HOP
F = N_FFT // 2 + 1


def gl_chains(kind="stft", la=0, ctx=None):
    """The streaming chain in ``pghi_gl`` in both packages."""
    kw = dict(n_fft=N_FFT, hop_length=HOP, inversion_mode="pghi_gl", gl_iterations=ITERS,
              gl_context=ctx, lookahead_frames=la)
    jt, pt = (JT.RealtimeDGT, PT.RealtimeDGT) if kind == "dgt" else (JT.RealtimeSTFT, PT.RealtimeSTFT)
    j = JT.OverlapAdd(N_FFT, HOP) + jt(**kw)
    p = PT.OverlapAdd(N_FFT, HOP, device="cpu") + pt(device="cpu", **kw)
    return j, p


def circle(a, b):
    d = np.angle(np.exp(1j * (np.float64(a) - np.float64(b))))
    return float(np.abs(d).max()) if d.size else 0.0


def low_tone_mags(kind, n=4 * CHUNK):
    x = tones(n, [(220, 440, 880), (330, 660)])
    _, pc = gl_chains(kind)
    spec, _ = PS.scan_forward(pc, torch.as_tensor(x), CHUNK, backend="generic")
    return x, t2n(spec.abs())


def draws(key, shape):
    return np.array(2.0 * jnp.pi * jax.random.uniform(key, shape))


def jax_project(jrt, mag_ext, ph_ext, T_out):
    """The JAX package's projection of ``RealtimeSTFT.pghi_gl_stream``, one
    iteration with its keep-mask, written from its own operations."""
    ctx, la = jrt.gl_context, jrt.lookahead_frames
    overlap = N_FFT // HOP
    spec = mag_ext * jnp.exp(1j * ph_ext)
    y = j_ola(j_irfft(spec, n_fft=N_FFT) * jrt.inv_window, HOP) / overlap
    fr = j_frame(y, N_FFT, HOP, -1)[..., : mag_ext.shape[-2], :]
    new = jnp.angle(j_rfft(fr * jrt.window))
    idx = jnp.arange(mag_ext.shape[-2])
    freeze_n = max(0, min(overlap - 1 - la, T_out))
    keep = (idx < ctx) | ((idx >= ctx + T_out - freeze_n) & (idx < ctx + T_out))
    return jnp.where(keep[:, None], ph_ext, new)


@pytest.mark.parametrize("la", [0, 2])
def test_projection_plain_version_matches_jax(la):
    jc, pc = gl_chains("stft", la)
    jrt, prt = jc[1], pc[1]
    rng = np.random.default_rng(5)
    ctx = prt.gl_context
    Tx = ctx + T_C + la
    mag = np.abs(rng.standard_normal((2, Tx, F))).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (2, Tx, F)).astype(np.float32)
    ref = np.array(jax_project(jrt, jnp.asarray(mag), jnp.asarray(ph), T_C))
    lo, hi = prt.gl_frozen(T_C)
    assert torch.equal(prt.gl_keep_rows(Tx, T_C), (torch.arange(Tx) < ctx) | ((torch.arange(Tx) >= lo)
                                                                             & (torch.arange(Tx) < hi)))
    pad = np.zeros((2, N_FFT // HOP - 1, F), np.float32)
    got = PK.gl_project_reference(torch.as_tensor(np.concatenate([mag, pad], 1)),
                                  torch.as_tensor(np.concatenate([ph, pad], 1)), prt.inv_window, prt.window,
                                  N_FFT, HOP, ctx, lo, hi)
    got = t2n(got)[:, :Tx]
    unit = lambda p: np.stack([mag * np.cos(p), mag * np.sin(p)])  # noqa: E731
    assert np.abs(unit(got) - unit(ref)).max() <= 1e-4 * mag.max()
    assert np.array_equal(got[:, :ctx], ph[:, :ctx]) and np.array_equal(got[:, lo:hi], ph[:, lo:hi])
    assert (hi - lo) == max(0, N_FFT // HOP - 1 - la)


@pytest.fixture(scope="module")
def session():
    x = make_audio(11, batch=2, n=3 * CHUNK + 300)[:, 0]   # 4 chunks, ragged tail
    return x, jax.random.PRNGKey(17)


@pytest.mark.parametrize("route", ["roundtrip", "decode"])
@pytest.mark.parametrize("la", [0, 2])
def test_plain_session_vs_pallas(session, route, la):
    """O's session on the CPU (its host loop over the recurrence's and the
    projection's plain versions) and O's plain session (``pghi_gl_stream``
    chunk by chunk) against the JAX kernel in interpret mode; at lookahead 2
    a chunk's fill grid has 10 frames, no multiple of 8.  The session and the
    plain session compute the same float32 function in another order (the
    projection as products against the bases or through ``torch.fft``, the
    magnitude carry as ``m`` or ``|m e^{i phi}|``): within 1e-4 of the
    largest value."""
    x, key = session
    jc, pc = gl_chains("stft", la)
    n_chunks = 4
    ang = np.array(JK._session_angles(key, n_chunks, T_C + la, F, 384, (2,)))[..., :F]
    a = torch.as_tensor(ang)
    if route == "roundtrip":
        y_p = PK.make_fused_pghi_gl_roundtrip(pc, CHUNK, angles=a)(torch.as_tensor(x))
        y_j = JK.make_fused_pghi_gl_roundtrip(jc, CHUNK, key=key, interpret=True)(jnp.asarray(x))
        assert y_p.shape == y_j.shape == (2, 4 * CHUNK)
        mag = PK.make_fused_magnitude_session(pc, CHUNK)(torch.as_tensor(x))
        T = mag.shape[1]
    else:
        spec, _ = PK.make_fused_forward_session(pc, CHUNK)(torch.as_tensor(x))
        mags = spec.abs()[:, :-3]
        y_p = PK.make_fused_pghi_gl_invert(pc, T_C, angles=a)(mags)
        y_j = JK.make_fused_pghi_gl_invert(jc, T_C, key=key, interpret=True)(jnp.asarray(t2n(mags)))
        assert y_p.shape == y_j.shape == (2, mags.shape[1] * HOP)
        T = mags.shape[1]
        mag = torch.nn.functional.pad(mags, (0, 0, 0, n_chunks * T_C - T))
    y_s = PK.session_pghi_gl_reference(mag, a, pc[1], float(pc[0].gain_compensation), T_C, T)
    assert y_s.shape == y_p.shape
    assert rel(t2n(y_p), np.array(y_j)) <= 1e-3 and rel(t2n(y_s), np.array(y_j)) <= 1e-3
    assert rel(t2n(y_p), t2n(y_s)) <= 1e-4


@pytest.mark.parametrize("kind,la", [("stft", 0), ("dgt", 0), ("stft", 2)])
def test_fused_routes_match_the_generic_scan(kind, la):
    """``scan_roundtrip`` / ``scan_invert`` in ``pghi_gl``: the session route
    (``backend="fused"``, the plain versions on the CPU) against the chunk
    scan with a generator in the same state, lengths and delay included."""
    x = make_audio(15, batch=2, n=3 * CHUNK + 300)[:, 0]
    _, pc = gl_chains(kind, la)
    xt = torch.as_tensor(x)
    d = N_FFT - HOP + la * HOP

    def pair(fn):
        a = t2n(fn(torch.Generator().manual_seed(7), "fused"))
        b = t2n(fn(torch.Generator().manual_seed(7), "generic"))
        assert a.shape == b.shape
        s_a = spectral_convergence(a[:, d:], x, N_FFT, HOP)
        s_b = spectral_convergence(b[:, d:], x, N_FFT, HOP)
        assert s_a <= 1.1 * s_b + 1e-3, (s_a, s_b)
        return a, s_b

    y, s_rt = pair(lambda g, b: PS.scan_roundtrip(pc, xt, CHUNK, "pghi_gl", generator=g, backend=b))
    assert y.shape == (2, 4 * CHUNK) and s_rt < 0.5
    spec, _ = PS.scan_forward(pc, xt, CHUNK, backend="generic")
    mags = spec.abs()[:, :-3]
    y, _ = pair(lambda g, b: PS.scan_invert(pc, mags, T_C, "pghi_gl", generator=g, backend=b))
    assert y.shape == (2, mags.shape[1] * HOP)
    three = pc + PT.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT, device="cpu")
    pair(lambda g, b: PS.scan_roundtrip(three, xt, CHUNK, "pghi_gl", generator=g, backend=b))


def test_seeded_recurrence_matches_jax_pghi_scan():
    """The recurrence's seeded one-chunk mode (plain version) against the JAX
    ``pghi_scan`` with the carry (backward stencil, one threshold over the
    chunk's frames): audible bins on the circle within 1e-3 rad, silent bins
    the draws."""
    rt = PT.RealtimeDGT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    _, mags = low_tone_mags("dgt")
    prev, m = mags[:, T_C - 2: T_C], mags[:, T_C: 2 * T_C + 2]    # 10 frames: T_c + lookahead 2
    prev_ph = np.random.default_rng(3).uniform(-np.pi, np.pi, (2, F)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    ref = np.array(j_pghi_scan(jnp.asarray(m), rt.gamma, N_FFT, HOP, tolerance=rt.tolerance,
                               prev_mag=jnp.asarray(prev), prev_phase=jnp.asarray(prev_ph), key=key,
                               time_stencil="backward"))
    a = torch.as_tensor(draws(key, m.shape))
    args = (rt.gamma, N_FFT, HOP, rt.tolerance, m.shape[1])
    got = PK.rt_pghi_phases_reference(torch.as_tensor(m), a, *args, prev_mag=torch.as_tensor(prev),
                                      prev_phase=torch.as_tensor(prev_ph))
    assert torch.equal(PK.rt_pghi_phases(torch.as_tensor(m), a, *args, prev_mag=torch.as_tensor(prev),
                                         prev_phase=torch.as_tensor(prev_ph)), got)
    loud = m > rt.tolerance * m.max()
    assert loud.mean() > 0.02
    assert circle(t2n(got)[loud], ref[loud]) <= 1e-3
    assert np.array_equal(t2n(got)[~loud], t2n(a)[~loud])
    with pytest.raises(ValueError, match="together"):
        PK.rt_pghi_phases(torch.as_tensor(m), a, *args, prev_mag=torch.as_tensor(prev))


def test_dispatch_of_the_pghi_gl_sessions():
    """The plans take O on a covered chain (on a CUDA tensor: data only, the
    plan reads the device type), its gates refuse a lookahead or a context
    longer than the chunk and an empty context, ``backend="fused"`` on the
    CPU runs the plain session without counting a launch, and ``sinebank``
    takes its closed form."""
    _, pc = gl_chains("dgt")
    three = pc + PT.Magnitude(device="cpu", n_fft=N_FFT)
    shape, yshape = (4, 4096), (4, 40, F)
    for dev in ("cpu", "cuda"):
        card = dev == "cuda"
        for chain in (pc, three):
            assert PS.plan_roundtrip(chain, shape, CHUNK, "pghi_gl", device=dev) == ("pghi_gl" if card else "generic")
            assert PS.plan_roundtrip(chain, shape, CHUNK, "pghi_gl", backend="fused", device=dev) == "pghi_gl"
            assert PS.plan_invert(chain, yshape, T_C, "pghi_gl", device=dev) == ("pghi_gl" if card else "generic")
        assert PS.plan_roundtrip(pc, shape, CHUNK, "sinebank", backend="fused", device=dev) == "sinebank"
    for la, ctx, ok in ((T_C, None, True), (T_C + 1, None, False), (0, T_C, True), (0, T_C + 1, False),
                        (0, 0, False)):
        _, c = gl_chains("stft", la, ctx)
        assert PK.fused_pghi_gl_roundtrip_available(c, CHUNK) is ok
        assert PK.fused_pghi_gl_invert_available(c, T_C) is ok
        assert PS.plan_roundtrip(c, shape, CHUNK, "pghi_gl", device="cuda") == ("pghi_gl" if ok else "generic")
        assert PS.plan_invert(c, yshape, T_C, "pghi_gl", device="cuda") == ("pghi_gl" if ok else "generic")
    # the kernels' own limits: the polish's grid in one block at a power of
    # two or an even 7-smooth n_fft (more than 40 polished frames too), at
    # most 40 polished frames on the two-launch route's product analysis
    # (n_fft 1408 = 2^7 11)
    assert PK.kernel_covers("project", N_FFT, HOP, T_C + 2) and PK.kernel_covers("project", N_FFT, HOP, 41)
    assert PK.kernel_covers("project", 1200, 300, 41)
    assert PK.kernel_covers("project", 1408, 352, 40) and not PK.kernel_covers("project", 1408, 352, 41)
    with pytest.raises(NotImplementedError, match="K10-K17"):
        PK._require("project", 1408, 352, 48)
    PK.reset_launches()
    x = torch.as_tensor(make_audio(4, batch=2, n=2 * CHUNK)[:, 0])
    y = PS.scan_roundtrip(pc, x, CHUNK, "pghi_gl", backend="fused")
    assert y.shape == (2, 2 * CHUNK) and all(v == 0 for v in PK.launches.values())
    assert {"rt_pghi_seeded", "gl_project_synthesis", "gl_project_analysis"} <= set(PK.launches)
