"""The plain PyTorch versions of the session kernels R, L, M and P
(``ops/cuda/stream_step.py``) against

* the JAX package's Pallas kernels in interpret mode, called as its own tests
  call them, with the same rows and the JAX package's session angles
  (``_session_angles``) handed over as numpy: within 1e-4 of the largest value
  for R and L (their TPU products are bf16x4) and 1e-3 for M and P (bf16x3,
  ``tests/test_streaming.py``);
* a float64 numpy oracle (``np.fft``, explicit overlap-add): within 1e-5;
* the port's own generic chunk scan with a generator in the same state:
  within 1e-5 (the sessions draw their angles as the scan does).

On the CPU the port's session wrappers run exactly these plain versions; the
CUDA kernels are held against them on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from test_torch_common import make_audio, rel, t2n

N_FFT, HOP, CHUNK = 512, 128, 1024
T_C = CHUNK // HOP


@pytest.fixture(scope="module")
def setup():
    x = make_audio(11, batch=2, n=3 * CHUNK + 300)[:, 0]  # 4 chunks, ragged tail
    jc = JT.OverlapAdd(N_FFT, HOP) + JT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP)
    pc = PT.OverlapAdd(N_FFT, HOP, device="cpu") + PT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    key = jax.random.PRNGKey(13)
    n_chunks = -(-x.shape[-1] // CHUNK)
    F = N_FFT // 2 + 1
    ang = np.array(JK._session_angles(key, n_chunks, T_C, F, 384, (2,)))[..., :F]
    return x, jc, pc, key, ang


def oracle(x, window, inv_window, gain, n_fft, hop, n_frames, angles=None, spec=None):
    """float64: frames of the row-padded signal, ``np.fft.rfft``; synthesis
    ``np.fft.irfft`` times the synthesis window over the gain, overlap-added
    and cut at ``n_frames * hop``."""
    window, inv_window = np.float64(window), np.float64(inv_window)
    if spec is None:
        rows = np.pad(np.float64(x), ((0, 0), (n_fft - hop, (n_frames - 1) * hop + hop - x.shape[-1])))
        idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        spec = np.fft.rfft(rows[:, idx] * window, axis=-1)
    if angles is not None:
        spec = np.abs(spec) * np.exp(1j * np.float64(angles[:, : spec.shape[1]]))
    frames = np.fft.irfft(spec, n=n_fft, axis=-1) * inv_window / gain
    B, T = frames.shape[:2]
    out = np.zeros((B, (T - 1) * hop + n_fft))
    for t in range(T):
        out[:, t * hop: t * hop + n_fft] += frames[:, t]
    return spec, out[:, : n_frames * hop]


def test_r_encode_vs_pallas_oracle_and_generic(setup):
    x, jc, pc, _, _ = setup
    spec_k, st_k = PK.make_fused_forward_session(pc, CHUNK)(torch.as_tensor(x))
    spec_j, st_j = JK.make_fused_forward_session(jc, CHUNK, interpret=True)(jnp.asarray(x))
    assert spec_k.shape == spec_j.shape == (2, 4 * T_C, N_FFT // 2 + 1)
    assert rel(t2n(spec_k), np.array(spec_j)) <= 1e-4
    spec_o, _ = oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), 4.0, N_FFT, HOP, 4 * T_C)
    assert rel(t2n(spec_k), spec_o) <= 1e-5
    spec_g, st_g = PS.scan_forward(pc, torch.as_tensor(x), CHUNK, backend="generic")
    assert rel(t2n(spec_k), t2n(spec_g)) <= 1e-5
    for a, b in zip(st_k, st_g):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert np.array_equal(t2n(st_k[0]["input_buffer"]), np.array(st_j[0]["input_buffer"]))


def test_l_complex_roundtrip_vs_pallas_oracle_and_generic(setup):
    x, jc, pc, _, _ = setup
    y_k = PK.make_fused_roundtrip(pc, CHUNK)(torch.as_tensor(x))
    y_j = JK.make_fused_roundtrip(jc, CHUNK, interpret=True)(jnp.asarray(x))
    assert y_k.shape == y_j.shape == (2, 4 * CHUNK)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-4
    _, y_o = oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), 4.0, N_FFT, HOP, 4 * T_C)
    assert rel(t2n(y_k), y_o) <= 1e-5
    assert rel(t2n(y_k), t2n(PS.scan_roundtrip(pc, torch.as_tensor(x), CHUNK, backend="generic"))) <= 1e-5
    # one stream without a batch axis
    y1 = PK.make_fused_roundtrip(pc, CHUNK)(torch.as_tensor(x[0]))
    assert y1.shape == (4 * CHUNK,) and rel(t2n(y1), t2n(y_k[0])) <= 1e-6


def test_m_random_roundtrip_vs_pallas_oracle_and_generic(setup):
    x, jc, pc, key, ang = setup
    y_k = PK.make_fused_random_roundtrip(pc, CHUNK, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    y_j = JK.make_fused_random_roundtrip(jc, CHUNK, key=key, interpret=True)(jnp.asarray(x))
    assert y_k.shape == y_j.shape
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-3
    _, y_o = oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), 4.0, N_FFT, HOP, 4 * T_C, angles=ang)
    assert rel(t2n(y_k), y_o) <= 1e-5
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    y_s = PK.make_fused_random_roundtrip(pc, CHUNK, generator=g1)(torch.as_tensor(x))
    y_g = PS.scan_roundtrip(pc, torch.as_tensor(x), CHUNK, "random", generator=g2, backend="generic")
    assert rel(t2n(y_s), t2n(y_g)) <= 1e-5


def test_p_random_decode_vs_pallas_oracle_and_generic(setup):
    x, jc, pc, key, ang = setup
    spec, _ = PK.make_fused_forward_session(pc, CHUNK)(torch.as_tensor(x))
    mags = spec.abs()[:, :-3]  # a ragged last chunk of frames
    T = mags.shape[1]
    y_k = PK.make_fused_random_invert(pc, T_C, angles=torch.as_tensor(ang))(mags)
    y_j = JK.make_fused_random_invert(jc, T_C, key=key, interpret=True)(jnp.asarray(t2n(mags)))
    assert y_k.shape == y_j.shape == (2, T * HOP)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-3
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), 4.0, N_FFT, HOP, T, angles=ang,
                    spec=np.float64(t2n(mags)))
    assert rel(t2n(y_k), y_o) <= 1e-5
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    y_s = PK.make_fused_random_invert(pc, T_C, generator=g1)(mags)
    y_g = PS.scan_invert(pc, mags, T_C, "random", generator=g2, backend="generic")
    assert rel(t2n(y_s), t2n(y_g)) <= 1e-5


def test_feature_chain_random_roundtrip_composes_r_and_p(setup):
    """``[OverlapAdd, RealtimeSTFT, Magnitude]`` in ``random`` mode: the
    session route (the magnitude encode, Magnitude forward and invert on the
    whole session, P) equals the generic scan with the same generator."""
    x, _, pc, _, _ = setup
    chain = pc + PT.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=N_FFT, device="cpu")
    g1, g2 = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    y_f = PS.scan_roundtrip(chain, torch.as_tensor(x), CHUNK, "random", generator=g1, backend="fused")
    y_g = PS.scan_roundtrip(chain, torch.as_tensor(x), CHUNK, "random", generator=g2, backend="generic")
    assert y_f.shape == y_g.shape and rel(t2n(y_f), t2n(y_g)) <= 1e-5
    feats, st = PS.scan_forward(chain, torch.as_tensor(x), CHUNK, backend="fused")
    feats_g, st_g = PS.scan_forward(chain, torch.as_tensor(x), CHUNK, backend="generic")
    assert rel(t2n(feats), t2n(feats_g)) <= 1e-5 and st[2] is None and st_g[2] is None
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    d_f = PS.scan_invert(chain, feats, T_C, "random", generator=g1, backend="fused")
    d_g = PS.scan_invert(chain, feats, T_C, "random", generator=g2, backend="generic")
    assert rel(t2n(d_f), t2n(d_g)) <= 1e-5


def test_gaussian_window_and_other_shapes(setup):
    """RealtimeDGT rides the same full-K sessions; 256/64 (overlap 4) and
    1024/128 (overlap 8) hold the oracle too."""
    x = setup[0]
    for n_fft, hop, rt in (
        (512, 128, PT.RealtimeDGT(n_fft=512, hop_length=128, inversion_mode="random", device="cpu")),
        (256, 64, PT.RealtimeSTFT(n_fft=256, hop_length=64, device="cpu")),
        (1024, 128, PT.RealtimeSTFT(n_fft=1024, hop_length=128, device="cpu")),
    ):
        pc = PT.OverlapAdd(n_fft, hop, device="cpu") + rt
        n_frames = 4 * CHUNK // hop
        y = PK.make_fused_roundtrip(pc, CHUNK)(torch.as_tensor(x))
        _, y_o = oracle(x, t2n(rt.window), t2n(rt.inv_window), n_fft / hop, n_fft, hop, n_frames)
        assert rel(t2n(y), y_o) <= 1e-5, (n_fft, hop)
        assert rel(t2n(y), t2n(PS.scan_roundtrip(pc, torch.as_tensor(x), CHUNK, backend="generic"))) <= 1e-5


def test_gates_and_kernel_limits():
    pc = PT.OverlapAdd(N_FFT, HOP, device="cpu") + PT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    assert PK.fused_roundtrip_available(pc, CHUNK)
    assert not PK.fused_roundtrip_available(pc, 1000)          # hop does not divide the chunk
    assert not PK.fused_roundtrip_available(pc, 256)           # chunk shorter than n_fft
    other = PT.OverlapAdd(N_FFT, 64, device="cpu") + PT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    assert not PK.fused_roundtrip_available(other, CHUNK)      # framings differ
    wide = PT.OverlapAdd(2048, 128, device="cpu") + PT.RealtimeSTFT(n_fft=2048, hop_length=128, device="cpu")
    assert not PK.fused_roundtrip_available(wide, 4096)        # overlap 16
    assert PK.fused_random_invert_available(pc, 8) and not PK.fused_random_invert_available(pc[0], 8)
    # the kernels' own limits: 16-byte rows, blocks that fit shared memory
    for kind in ("encode", "roundtrip", "decode"):
        assert PK.kernel_covers(kind, 1024, 256) and PK.kernel_covers(kind, 2048, 512)
        assert not PK.kernel_covers(kind, 1026, 342)           # hop % 4 != 0
    assert PK._pick_rows("roundtrip", 1024, 256) == 32 and PK._pick_rows("roundtrip", 2048, 512) == 15
    assert PK._pick_rows("encode", 1024, 256) == 40 and PK._pick_rows("decode", 1024, 256) == 40
    assert not PK.kernel_covers("roundtrip", 8192, 1024)       # not even one chunk's frames fit
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PK._require("roundtrip", 8192, 1024)
    # the RT-PGHI sessions (N, Q) and the complex decode (S) share the
    # structural gate; the recurrence holds at most 4096 bins in one block
    assert PK.fused_pghi_roundtrip_available(pc, CHUNK) and not PK.fused_pghi_roundtrip_available(pc, 1000)
    assert PK.fused_pghi_invert_available(pc, 8) and PK.fused_complex_invert_available(pc, 8)
    assert PK.kernel_covers("recurrence", 4096, 1024) and not PK.kernel_covers("recurrence", 8192, 2048)
    with pytest.raises(NotImplementedError, match="4096 bins"):
        PK._require("recurrence", 8192, 2048)
    assert PK._require("recurrence", 1024, 256) is None
    # the magnitude encode takes R's block, S takes P's
    assert PK._require("encode", 1024, 256) == 40 and PK._require("decode", 1024, 256) == 40
    # nothing counts a launch on the CPU
    PK.reset_launches()
    PK.make_fused_roundtrip(pc, CHUNK)(torch.zeros(2, 3000))
    PK.make_fused_pghi_roundtrip(pc, CHUNK)(torch.zeros(2, 3000))
    PK.make_fused_pghi_invert(pc, 8)(torch.zeros(2, 20, 257))
    PK.make_fused_magnitude_session(pc, CHUNK)(torch.zeros(2, 3000))
    assert all(v == 0 for v in PK.launches.values())
    assert {"session_magnitude", "rt_pghi_phases", "session_complex_decode"} <= set(PK.launches)
