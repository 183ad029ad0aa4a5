"""The streaming ``pghi_gl`` state of the port against the JAX package's:
``RealtimeSTFT`` / ``RealtimeDGT.init_state`` in mode ``pghi_gl``, two chained
eager ``step_invert`` calls, a JAX session resumed in the port through
``convert.load_jax_stream_state``, with and without lookahead, and
``RealtimeSTFT.test_inversion``; at n_fft 512/128, chunks of 8 frames, 4
Griffin-Lim iterations (the sessions are in ``test_torch_stream_pghi_gl.py``).

Tolerances, and why: the eager steps take the JAX draws as ``angles=``;
frames within 1e-4 of their largest value, ``gl_mag`` and ``la_mag`` within
1e-5, ``gl_phase`` and ``phase_buffer`` on the circle within 1e-3 rad on the
audible bins (above 1e-2 of the chunk's largest magnitude: a quiet bin's angle
is only as good as its magnitude), float32 sums in another order; the low
tones keep the phases small.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.convert import load_jax_stream_state
from test_torch_common import rel, t2n, tones
from test_torch_stream_pghi_gl import CHUNK, F, HOP, N_FFT, T_C, circle, draws, gl_chains, low_tone_mags
from test_torch_streaming import spectral_convergence


@pytest.mark.parametrize("la", [0, 2])
@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_init_state_shapes_match_jax(kind, la):
    jc, pc = gl_chains(kind, la)
    js, ps = jc[1].init_state((3,), mode="pghi_gl"), pc[1].init_state((3,), mode="pghi_gl")
    assert {k: tuple(v.shape) for k, v in ps.items()} == {k: v.shape for k, v in js.items()}
    want = {"mag_buffer", "phase_buffer", "gl_mag", "gl_phase"} | ({"la_mag"} if la else set())
    assert set(ps) == want and all(v.abs().max() == 0 for v in ps.values())
    assert ps["gl_mag"].shape == (3, N_FFT // HOP - 1, F)
    # the chain's default mode is the transform's: the DGT inherits pghi_gl
    assert set(pc.init_state((3,))[1]) == want
    assert [sorted(s) for s in pc.init_state((3,))] == [sorted(s) for s in jc.init_state((3,))]


@pytest.mark.parametrize("kind,la", [("stft", 0), ("dgt", 0), ("stft", 2)])
def test_two_chained_step_inverts_match_jax(kind, la):
    """``step_invert(pghi_gl)`` twice, state carried: frames, ``gl_mag`` and
    the phase carries as the JAX package's, its seed's draws pinned."""
    jc, pc = gl_chains(kind, la)
    _, mags = low_tone_mags(kind)
    js, ps = jc[1].init_state((2,), mode="pghi_gl"), pc[1].init_state((2,), mode="pghi_gl")
    for i in range(2):
        m = mags[:, i * T_C: (i + 1) * T_C]
        key = jax.random.PRNGKey(30 + i)
        js, jy = jc[1].step_invert(js, jnp.asarray(m), inversion_mode="pghi_gl", key=key)
        a = torch.as_tensor(draws(key, (2, T_C + la, F)))
        ps, py = pc[1].step_invert(ps, torch.as_tensor(m), inversion_mode="pghi_gl", angles=a)
        assert py.shape == jy.shape == (2, T_C, N_FFT)
        assert rel(t2n(py), np.array(jy)) <= 1e-4, i
        assert np.abs(t2n(ps["gl_mag"]) - np.array(js["gl_mag"])).max() <= 1e-5 * mags.max()
        loud = np.array(js["gl_mag"]) > 1e-2 * m.max()
        assert loud.mean() > 0.02
        assert circle(t2n(ps["gl_phase"])[loud], np.array(js["gl_phase"])[loud]) <= 1e-3
        loud_last = np.array(js["mag_buffer"])[:, 1] > 1e-2 * m.max()
        assert circle(t2n(ps["phase_buffer"])[loud_last], np.array(js["phase_buffer"])[loud_last]) <= 1e-3
        if la:
            assert np.abs(t2n(ps["la_mag"]) - np.array(js["la_mag"])).max() <= 1e-5 * mags.max()
    # the eager invert keeps the session on the transform
    rt = pc[1]
    rt._state = None
    y1 = rt.invert(torch.as_tensor(mags[:, :T_C]), angles=torch.as_tensor(draws(jax.random.PRNGKey(30),
                                                                                (2, T_C + la, F))))
    assert set(rt._state) >= {"gl_mag", "gl_phase"} and y1.shape == (2, T_C, N_FFT)
    with pytest.raises(KeyError, match="pinned-context"):
        rt.pghi_gl_stream(rt.init_state((2,), mode="pghi"), torch.as_tensor(mags[:, :T_C]))


@pytest.mark.parametrize("la", [0, 2])
def test_resume_a_jax_pghi_gl_session_in_the_port(la):
    """Two chunks of a JAX ``pghi_gl`` roundtrip, its state carried across by
    ``convert``, two more chunks in each package (the JAX draws pinned): the
    continuation's audio and carries agree."""
    x = tones(4 * CHUNK, [(220, 440, 880), (330, 660)])
    jc, pc = gl_chains("dgt", la)

    def jax_chunk(st, c, i):
        st0, fr = jc[0].step(st[0], jnp.asarray(c))
        mag = jnp.abs(jc[1].forward(fr))
        key = jax.random.PRNGKey(50 + i)
        st1, y = jc[1].step_invert(st[1], mag, inversion_mode="pghi_gl", key=key)
        st0, out = jc[0].step_invert(st0, y)
        return [st0, st1], out, draws(key, (2, T_C + la, F))

    jst = jc.init_state((2,), mode="pghi_gl")
    for i in range(2):
        jst, _, _ = jax_chunk(jst, x[:, i * CHUNK: (i + 1) * CHUNK], i)
    pst = load_jax_stream_state(pc, jax.tree_util.tree_map(np.asarray, jst))
    want = {"mag_buffer", "phase_buffer", "gl_mag", "gl_phase"} | ({"la_mag"} if la else set())
    assert set(pst[1]) == want
    for i in range(2, 4):
        c = x[:, i * CHUNK: (i + 1) * CHUNK]
        jst, jout, a = jax_chunk(jst, c, i)
        st0, fr = pc[0].step(pst[0], torch.as_tensor(c))
        st1, y = pc[1].step_invert(pst[1], pc[1].forward(fr).abs(), "pghi_gl", angles=torch.as_tensor(a))
        st0, pout = pc[0].step_invert(st0, y)
        pst = [st0, st1]
        assert rel(t2n(pout), np.array(jout)) <= 1e-4, i
    assert np.abs(t2n(pst[1]["gl_mag"]) - np.array(jst[1]["gl_mag"])).max() <= 1e-5
    # a JAX pghi_gl state does not fit a chain configured otherwise
    _, other = gl_chains("dgt", 0 if la else 2)
    with pytest.raises(ValueError):
        load_jax_stream_state(other, jax.tree_util.tree_map(np.asarray, jst))


def test_test_inversion_covers_pghi_gl():
    """``RealtimeSTFT.test_inversion`` runs every streaming mode the port
    has, ``pghi_gl`` now among them, as the JAX package's does."""
    rt = PT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, gl_iterations=2, device="cpu")
    x = torch.as_tensor(tones(2 * 4 * N_FFT, [(220, 440)]))
    outs = rt.test_inversion(x)
    jt = JT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP)
    assert set(outs) == {"direct"} | set(jt.get_inversion_modes())
    assert all(v.shape == x.shape and torch.isfinite(v).all() for v in outs.values())
    # the polish reconstructs the low tone no worse than the seed alone
    d = N_FFT - HOP
    sc = {m: spectral_convergence(t2n(outs[m])[..., d:], t2n(x), N_FFT, HOP) for m in ("pghi", "pghi_gl")}
    assert sc["pghi_gl"] <= 1.1 * sc["pghi"] + 1e-3, sc
