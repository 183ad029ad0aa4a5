"""``acids_transforms_tpu_torch/serving.py`` on the CPU, case by case after
the non-mesh tests of ``tests/test_serving.py``: bucket dispatch, trim,
snapshot and refresh, the bucketed invert, the warmup count, the recorded
input shapes (no new one after warmup), int16 ingest, and the live session
against the eager step loop and against the JAX session.

Tolerances: the port against the JAX package's XLA path (its chain's
``forward``, or its server where that is an XLA program) within 1e-4
max-abs over max-abs; the server against the port's own unbucketed call
within 1e-5 on interior frames (the JAX test's atol); bit-identical where
both sides run the same port code."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.serving import CompiledTransform as JCompiledTransform
from acids_transforms_tpu.serving import StreamingSession as JStreamingSession
from acids_transforms_tpu_torch.serving import CompiledTransform, StreamingSession
from acids_transforms_tpu_torch.utils import default_buckets, frame_mask, pad_to_bucket
from test_torch_common import Mesh4, carry_over, rel, t2n

D = "cpu"
RNG = np.random.default_rng(9)
N_FFT, HOP = 512, 128
T_INTERIOR = (7000 - N_FFT // 2) // HOP   # frames of a 7000-sample clip clear of the bucket padding


def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _stft_mag(mel=False, contrast="log1p", mono=False):
    """``[Mono +] STFT(512, 128) + Magnitude(unipolar)`` in both packages."""
    kw = dict(mode="unipolar", contrast=contrast, mel=mel, n_fft=N_FFT)
    jc = JT.STFT(n_fft=N_FFT, hop_length=HOP) + JT.Magnitude(**kw)
    pc = PT.STFT(n_fft=N_FFT, hop_length=HOP, device=D) + PT.Magnitude(device=D, **kw)
    if mono:
        jc, pc = JT.Mono() + jc, PT.Mono(device=D) + pc
    return jc, pc


def _fitted(jc, pc, x):
    jf = jc.fit(jnp.asarray(x))
    carry_over(jf, pc)
    return jf, pc


@pytest.fixture(scope="module")
def served():
    jc, pc = _stft_mag()
    jf, pf = _fitted(jc, pc, _randn(2, 8192))
    return jf, CompiledTransform(pf, buckets=(8192, 16384), batch_sizes=(2, 4))


def test_forward_matches_unpadded(served):
    jf, server = served
    x = _randn(2, 7000)
    y = server.forward(torch.as_tensor(x))
    ref = server.transform.forward(torch.as_tensor(x))
    assert y.shape == ref.shape
    assert np.abs(t2n(y) - t2n(ref))[..., :T_INTERIOR, :].max() <= 1e-5
    # the JAX server (an XLA program for this unfused chain) on the same input
    jy = np.asarray(JCompiledTransform(jf, buckets=(8192, 16384), batch_sizes=(2, 4)).forward(jnp.asarray(x)))
    assert jy.shape == y.shape and rel(t2n(y), jy) <= 1e-4


def test_batch_and_length_padding(served):
    _, server = served
    y = server.forward(torch.as_tensor(_randn(3, 10000)))   # batch 3 -> 4, length -> 16384
    assert y.shape[0] == 3 and y.shape[-2] == 10000 // HOP + 1


def test_out_of_range_raises(served):
    _, server = served
    with pytest.raises(ValueError, match="bucket ladder"):
        server.forward(torch.zeros((2, 100000)))
    with pytest.raises(ValueError, match="batch_sizes"):
        server.forward(torch.zeros((5, 1000)))


def test_warmup_counts_and_no_new_shape_after_it(served):
    _, server = served
    assert server.warmup() == 8   # 2 buckets x 2 batch sizes, forward + invert each
    before = {k: set(v) for k, v in server.shapes.items()}
    assert len(before["forward"]) == 4 and len(before["invert"]) == 4
    for b, n in ((1, 3000), (2, 8192), (3, 9000), (4, 16384)):
        server.invert(server.forward(torch.as_tensor(_randn(b, n))))
    assert server.shapes == before


def test_invert_path(served):
    _, server = served
    m = server.invert(server.forward(torch.as_tensor(_randn(2, 8192))))
    assert torch.isfinite(m).all()


def test_invert_bucketed_shape_discipline(served):
    """Distinct frame counts inside one bucket share one inverse shape, and
    each comes out at its own unbucketed length."""
    _, server = served
    before = set(server.shapes["invert"])
    for t in (40, 50, 60):   # all <= 8192 // 128 + 1 = 65
        out = server.invert(torch.as_tensor(_randn(2, t, 257)))
        assert out.shape[-1] == (t - 1) * HOP
    assert len(server.shapes["invert"] - before) <= 1


def test_invert_matches_unbucketed_interior(served):
    _, server = served
    y = torch.as_tensor(0.1 * np.abs(_randn(2, 50, 257)))
    rec = server.invert(y)
    assert rec.shape == server.transform.invert(y, inversion_mode="griffin_lim").shape


def test_mfcc_bin_major_trim():
    """Bin-major ``(n_mels, T)`` output: the frame axis is trimmed, not the
    mel axis; the served MFCC (the fused formulation) against the chain and
    against JAX's chain."""
    pc = PT.ComposeAudioTransform([PT.MFCC(n_fft=N_FFT, hop_length=HOP, n_mels=64, device=D)])
    jc = JT.ComposeAudioTransform([JT.MFCC(n_fft=N_FFT, hop_length=HOP, n_mels=64)])
    server = CompiledTransform(pc, buckets=(8192, 16384), batch_sizes=(2,))
    x = _randn(2, 7000)
    y = server.forward(torch.as_tensor(x))
    ref = pc.forward(torch.as_tensor(x))
    assert y.shape == ref.shape == (2, 64, 55)
    assert rel(t2n(y)[..., :T_INTERIOR], t2n(ref)[..., :T_INTERIOR]) <= 1e-5
    jy = np.asarray(jc.forward(jnp.asarray(x)))
    assert rel(t2n(y)[..., :T_INTERIOR], jy[..., :T_INTERIOR]) <= 1e-4


@pytest.mark.parametrize("mel", [True, False])
def test_refit_requires_refresh(mel):
    fit_x = torch.as_tensor(_randn(2, 1, 8192))
    x = torch.as_tensor(_randn(2, 1, 8192))
    _, chain = _stft_mag(mel=mel, mono=True)
    chain.scale_data(fit_x)
    server = CompiledTransform(chain, buckets=(8192,), batch_sizes=(2,))
    y0 = server.forward(x)
    chain.scale_data(100.0 * fit_x)      # refit the live transform
    assert torch.equal(server.forward(x), y0)   # the snapshot: unchanged
    server.refresh()
    y2 = server.forward(x)
    assert rel(t2n(y2), t2n(chain.forward(x))) <= 2e-4
    assert (y2 - y0).abs().max() > 1e-3   # the refit now visible


def test_window_chain_no_new_shape_after_warmup():
    """The frame ladder comes from the chain itself, so warmup covers every
    runtime invert shape: a Window chain's ``(b - size) // hop + 1`` differs
    from the STFT formula."""
    pc = PT.ComposeAudioTransform([PT.Window(window_size=512, hop_size=256, device=D)])
    jc = JT.ComposeAudioTransform([JT.Window(window_size=512, hop_size=256)])
    server = CompiledTransform(pc, buckets=(4096, 8192), batch_sizes=(2,))
    server.warmup()
    before = {k: set(v) for k, v in server.shapes.items()}
    for L in (3000, 4096, 5000, 8192):
        x = _randn(2, L)
        y = server.forward(torch.as_tensor(x))
        assert np.array_equal(t2n(y), np.asarray(jc.forward(jnp.asarray(x))))
        rec = server.invert(y)
        assert rec.shape == pc.invert(pc.forward(torch.as_tensor(x))).shape and torch.isfinite(rec).all()
    assert server.shapes == before
    assert server._t_ladder() == ((4096 - 512) // 256 + 1, (8192 - 512) // 256 + 1)


def test_mfcc_chain_no_new_shape_after_warmup():
    pc = PT.ComposeAudioTransform([PT.MFCC(n_fft=N_FFT, hop_length=HOP, n_mels=64, device=D)])
    server = CompiledTransform(pc, buckets=(4096, 8192), batch_sizes=(2,))
    assert server.warmup() == 2   # MFCC is not invertible: forwards only
    before = set(server.shapes["forward"])
    for L in (3000, 4096, 6000, 8192):
        server.forward(torch.as_tensor(_randn(2, L)))
    assert server.shapes["forward"] == before
    assert server._t_ladder() == (4096 // HOP + 1, 8192 // HOP + 1)


def test_serving_int16_pcm_ingest():
    """``warmup(dtypes=(float32, int16))`` covers the PCM shapes, an int16
    request is bit-identical to the pre-converted float one, and an unmatched
    chain refuses PCM."""
    xi = RNG.integers(-32768, 32768, size=(2, 8192), dtype=np.int16)
    xf = xi.astype(np.float32) / 32768.0
    _, pc = _stft_mag(mel=True)
    chain = pc.fit(torch.as_tensor(xf))
    server = CompiledTransform(chain, buckets=(8192, 12288), batch_sizes=(2,))
    assert server.warmup(dtypes=(torch.float32, torch.int16)) == 6   # 2 x (fwd + inv), 2 int16 fwds
    before = set(server.shapes["forward"])
    for L in (6000, 8192, 12000):
        y_i = server.forward(torch.as_tensor(xi[:, :L]))
        assert torch.equal(y_i, server.forward(torch.as_tensor(xf[:, :L]))), L
    assert server.shapes["forward"] == before
    raw = CompiledTransform(PT.ComposeAudioTransform([PT.MuLaw(device=D)]), buckets=(8192,), batch_sizes=(2,))
    with pytest.raises(ValueError, match="int16"):
        raw.forward(torch.as_tensor(xi))
    with pytest.raises(ValueError, match="int16"):
        raw.warmup(dtypes=(torch.int16,))


def test_frame_axis_protocol():
    assert (PT.Mono(device=D) + PT.STFT(n_fft=N_FFT, hop_length=HOP, device=D)
            + PT.Magnitude(mode=None, mel=False, n_fft=N_FFT, device=D)).output_frame_axis(None) == -2
    assert PT.MFCC(device=D).output_frame_axis(None) == -1
    stft = PT.STFT(device=D)
    assert (stft + PT.Transpose(dims=(-2, -1), device=D)).output_frame_axis(None) == -1
    assert (stft + PT.Unsqueeze(dim=-1, device=D)).output_frame_axis(None) == -3
    assert (stft + PT.Polar(stack=-2, device=D)).output_frame_axis(None) == -3
    assert PT.Mono(device=D).output_frame_axis(None) is None
    server = CompiledTransform(stft + PT.Polar(stack=-2, device=D), buckets=(8192,), batch_sizes=(1,))
    assert server.frame_axis == -3


def test_serving_4096_region_matches_chain():
    """n_fft 4096 through the fused dispatch under the server: the port's
    chain and the JAX chain within the 1e-4 budget on interior frames."""
    kw = dict(mode="unipolar", contrast="log1p", mel=True, n_fft=4096)
    jc = JT.Mono() + JT.STFT(n_fft=4096, hop_length=512) + JT.Magnitude(**kw)
    pc = PT.Mono(device=D) + PT.STFT(n_fft=4096, hop_length=512, device=D) + PT.Magnitude(device=D, **kw)
    jf, pf = _fitted(jc, pc, _randn(2, 32768))
    server = CompiledTransform(pf, buckets=(32768,), batch_sizes=(2,))
    x = _randn(2, 30000)
    y = t2n(server.forward(torch.as_tensor(x)))
    t_in = (30000 - 4096 // 2) // 512
    for ref in (t2n(pf.forward(torch.as_tensor(x))), np.asarray(jf.forward(jnp.asarray(x)))):
        assert y.shape == ref.shape
        assert rel(y[..., :t_in, :], ref[..., :t_in, :]) <= 1e-4


def test_serving_dgt_chain_roundtrip():
    kw = dict(mode="unipolar", mel=True, n_fft=N_FFT)
    jc = JT.Mono() + JT.DGT(n_fft=N_FFT, hop_length=HOP) + JT.Magnitude(**kw)
    pc = PT.Mono(device=D) + PT.DGT(n_fft=N_FFT, hop_length=HOP, device=D) + PT.Magnitude(device=D, **kw)
    jf, pf = _fitted(jc, pc, _randn(2, 2, 8192))
    srv = CompiledTransform(pf, buckets=(8192,), batch_sizes=(2,))
    x = _randn(2, 2, 7000)
    y = t2n(srv.forward(torch.as_tensor(x)))
    t_in = (7000 - 256) // HOP
    for ref in (t2n(pf.forward(torch.as_tensor(x))), np.asarray(jf.forward(jnp.asarray(x)))):
        assert y.shape == ref.shape and rel(y[..., :t_in, :], ref[..., :t_in, :]) <= 1e-4
    rec = srv.invert(torch.as_tensor(y))   # DGT's default mode (pghi)
    assert rec.shape == pf.invert(torch.as_tensor(y)).shape and torch.isfinite(rec).all()


def test_serving_stacked_representation_roundtrip():
    """PolarIF stacked on -2: the fused dispatch, the frame ladder over the
    stacked layout and the bucketed invert (IF integration -> ISTFT)."""
    margs = {"mode": "unipolar", "mel": False, "n_fft": N_FFT}
    jc = JT.Mono() + JT.STFT(n_fft=N_FFT, hop_length=HOP) + JT.PolarIF(magnitude_args=margs)
    pc = PT.Mono(device=D) + PT.STFT(n_fft=N_FFT, hop_length=HOP, device=D) + PT.PolarIF(
        magnitude_args=margs, device=D)
    jf, pf = _fitted(jc, pc, _randn(2, 2, 8192))
    srv = CompiledTransform(pf, buckets=(8192,), batch_sizes=(2,))
    x = _randn(2, 2, 7000)
    y = srv.forward(torch.as_tensor(x))
    t_in = (7000 - 256) // HOP
    ref = t2n(pf.forward(torch.as_tensor(x)))
    assert y.shape == ref.shape and rel(t2n(y)[..., :t_in, :, :], ref[..., :t_in, :, :]) <= 1e-4
    jy = np.asarray(jf.forward(jnp.asarray(x)))
    assert jy.shape == y.shape and rel(t2n(y)[..., :t_in, 0, :], jy[..., :t_in, 0, :]) <= 1e-4
    rec = srv.invert(y)
    assert torch.isfinite(rec).all()
    # the phase-faithful IF roundtrip: the served invert's spectrogram is the input's
    stft_t = PT.STFT(n_fft=N_FFT, hop_length=HOP, device=D)
    mono_x = PT.Mono(device=D).forward(torch.as_tensor(x))
    rec2 = rec.reshape(mono_x.shape[0], -1)[:, : mono_x.shape[-1]]
    a, b = stft_t.forward(rec2).abs(), stft_t.forward(mono_x).abs()
    n = min(a.shape[-2], b.shape[-2]) - 4
    assert (torch.linalg.norm(a[:, 2:n] - b[:, 2:n]) / torch.linalg.norm(b[:, 2:n])).item() < 1e-4


def test_serving_ctor_contracts():
    with pytest.raises(ValueError, match="stack"):
        CompiledTransform(PT.STFT(n_fft=N_FFT, hop_length=HOP, device=D) + PT.Polar(stack=None, device=D),
                          buckets=(8192,))
    _, pc = _stft_mag()
    chain = pc.fit(torch.as_tensor(_randn(2, 8192)))
    srv = CompiledTransform(chain, buckets=(16384, 8192), batch_sizes=(4, 2))
    assert srv.buckets == (8192, 16384) and srv.batch_sizes == (2, 4)
    with pytest.raises(ValueError, match="16384"):
        srv.forward(torch.zeros((2, 20000)))
    assert CompiledTransform(chain, batch_sizes=(1,)).buckets == default_buckets(max_seconds=30.0)
    # mesh= (tests/test_torch_parallel.py runs it on 4 ranks): the checks
    # made before any rank is asked, on a mesh of 4 on its axis
    with pytest.raises(ValueError, match="do not divide the mesh axis 'data'"):
        CompiledTransform(chain, batch_sizes=(2, 4), mesh=Mesh4())
    with pytest.raises(ValueError, match="batched session"):
        StreamingSession(chain, 1024, mesh=Mesh4())


def test_bucketing_utils_match_jax():
    from acids_transforms_tpu.utils import bucketing as jb

    assert default_buckets() == jb.default_buckets()
    assert default_buckets(0.5, 10.0, 16000, 2.0) == jb.default_buckets(0.5, 10.0, 16000, 2.0)
    x = _randn(2, 3, 1000)
    for buckets in ((512, 2048), (256, 400)):
        pp, pm, pb = pad_to_bucket(torch.as_tensor(x), buckets)
        jp, jm, jbk = jb.pad_to_bucket(x, buckets)
        assert pb == jbk and np.array_equal(t2n(pp), np.asarray(jp)) and np.array_equal(t2n(pm), np.asarray(jm))
        assert np.array_equal(t2n(frame_mask(pm, 512, 128)), np.asarray(jb.frame_mask(jm, 512, 128)))
    xi = torch.as_tensor(RNG.integers(-5, 5, (2, 100), dtype=np.int16))
    assert pad_to_bucket(xi, (128,))[0].dtype == torch.int16


# ===================================================== live streaming session

def _stream_chains(mode):
    jc = JT.OverlapAdd(N_FFT, HOP) + JT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode=mode or "random")
    pc = PT.OverlapAdd(N_FFT, HOP, device=D) + PT.RealtimeSTFT(
        n_fft=N_FFT, hop_length=HOP, inversion_mode=mode or "random", device=D)
    return jc, pc


def test_streaming_session_matches_eager_loop():
    """``process`` equals an eager loop of ``step`` / ``step_invert`` with a
    generator seeded alike (bit-identical: the same port code); encode and
    decode halves compose to ``process``; ``reset`` and ``warmup`` give back
    the first utterance."""
    chunk = 1024
    _, chain = _stream_chains("pghi")
    x = torch.as_tensor(_randn(4 * chunk))
    sess = StreamingSession(chain, chunk, inversion_mode="pghi", seed=3)
    sess.warmup()
    outs = [sess.process(x[i * chunk: (i + 1) * chunk]) for i in range(4)]

    st = chain.init_state((), mode="pghi")
    g = torch.Generator().manual_seed(3)
    for i in range(4):
        st, y = chain.step(st, x[i * chunk: (i + 1) * chunk])
        st, rec = chain.step_invert(st, y.abs(), inversion_mode="pghi", generator=g)
        assert torch.equal(rec, outs[i]), i

    enc = StreamingSession(chain, chunk, inversion_mode="pghi", seed=3)
    dec = StreamingSession(chain, chunk, inversion_mode="pghi", seed=3)
    for i in range(4):
        f = enc.encode(x[i * chunk: (i + 1) * chunk])
        assert torch.equal(dec.decode(f.abs()), outs[i])

    sess.reset()
    sess.generator.manual_seed(3)
    assert torch.equal(sess.process(x[:chunk]), outs[0])

    bs = StreamingSession(chain, chunk, batch_shape=(2,), inversion_mode="pghi")
    assert bs.process(torch.as_tensor(_randn(2, chunk))).shape == (2, chunk)


def test_streaming_session_matches_jax_without_draws():
    """The complex roundtrip (no inversion mode: nothing drawn) against the
    JAX session, chunk by chunk, and the frame times of ``encode``."""
    chunk = 1024
    jc, pc = _stream_chains(None)
    x = _randn(2, 3 * chunk)
    js = JStreamingSession(jc, chunk, batch_shape=(2,))
    ps = StreamingSession(pc, chunk, batch_shape=(2,))
    for i in range(3):
        xc = x[:, i * chunk: (i + 1) * chunk]
        jy = np.asarray(js.process(jnp.asarray(xc)))
        py = t2n(ps.process(torch.as_tensor(xc)))
        assert py.shape == jy.shape and rel(py, jy) <= 1e-4
    ps.reset()
    js.reset()
    for i in range(2):
        xc = x[:, i * chunk: (i + 1) * chunk]
        jf, jt = js.encode(jnp.asarray(xc), with_time=True)
        pf, pt = ps.encode(torch.as_tensor(xc), with_time=True)
        assert rel(t2n(pf), np.asarray(jf)) <= 1e-4
        assert pt.device.type == "cpu" and np.allclose(pt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
