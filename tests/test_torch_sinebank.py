"""The sinebank resynthesis of the port against the JAX package on the CPU:
``ops/interp.py:interp_linear``, the offline mode of ``STFT`` / ``DGT``
(``get_sinebank_inversion``), ``RealtimeSTFT.sinebank_stream`` chunk by chunk,
and the streaming closed form (``streaming._sinebank_session``) against the
generic chunk scan in every case of the JAX package's own test
(``tests/test_streaming.py:test_sinebank_session_closed_form_matches_generic``).

The JAX package's phases are drawn by JAX and carried across (``angles=`` of
the offline mode, ``convert.load_jax_stream_state`` for the stream).  The
float32 grids are bit-equal to ``jnp.linspace``'s, and the offline angle is
rounded once as XLA's fused multiply-add rounds it, so the offline output sits
within 1e-5 relative L2 of JAX's (at most 1.25x JAX's error against a float64
oracle of the same formula); each streaming chunk within 1e-4 of JAX's eager
step with ``time_index`` bit-equal; the closed form within 5e-3 relative L2 of
the generic scan (JAX's own bound) and within 1e-5 (both routes build the same
angles; a clock that drifts by float32 rounding fails it).  Clips of at most
0.3 s at 44.1 kHz.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu import streaming as JS
from acids_transforms_tpu.ops.interp import interp_linear as j_interp
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.convert import load_jax_stream_state
from acids_transforms_tpu_torch.ops.interp import interp_linear
from acids_transforms_tpu_torch.transforms.stft import linspace32
from test_torch_common import HOP, N_FFT, SR, jax_angles, make_audio, rel, t2n

torch.set_num_threads(1)
F = N_FFT // 2 + 1
CHUNK = 2048
T_C = CHUNK // HOP


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("stop,num", [(SR / 2.0, F), (SR / 2.0, 1025), (HOP * 40 / SR + N_FFT / SR, HOP * 40 + N_FFT),
                                      (4.0, 176640), (176640 / SR, 176640), (1.0, 2), (1.0, 1)])
def test_grids_are_jnp_linspace_bit_for_bit(stop, num):
    """``torch.linspace`` is not (it fills its second half from the end)."""
    got = t2n(linspace32(stop, num))
    want = np.asarray(jnp.linspace(0.0, stop, num))
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n_in,n_out", [(40, 5632), (97, 12544), (5, 3), (1, 7)])
def test_interp_linear(n_in, n_out):
    x = np.random.default_rng(n_in).random((2, 3, n_in), dtype=np.float32)
    got = t2n(interp_linear(torch.as_tensor(x), n_out))
    ref = torch.nn.functional.interpolate(torch.as_tensor(x), size=n_out, mode="linear", align_corners=False)
    assert got.shape == (2, 3, n_out)
    assert np.abs(got - t2n(ref)).max() <= 1e-5
    assert np.abs(got - np.asarray(j_interp(jnp.asarray(x), n_out))).max() <= 1e-6


def oracle(mag: np.ndarray, phi: np.ndarray, n_fft: int, hop: int, sr: int = SR) -> np.ndarray:
    """The offline sinebank formula in float64."""
    T, n_bins = mag.shape[-2:]
    m = mag.astype(np.float64)
    m = m / np.abs(m).max()
    L = hop * T + n_fft
    f = np.linspace(0.0, sr / 2.0, n_bins)
    t = np.linspace(0.0, L / sr, L)
    src = np.clip((np.arange(L) + 0.5) * T / L - 0.5, 0, T - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    w = src - lo
    mT = np.swapaxes(m, -2, -1)
    env = (mT[..., lo] * (1 - w) + mT[..., hi] * w) / (2 * np.pi)
    y = (env * np.sin(2 * np.pi * f[:, None] * t + phi.astype(np.float64)[:, None])).sum(-2)
    return y / np.abs(y).max()


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_offline_sinebank_vs_jax(kind):
    x = make_audio(71, batch=2, n=12000)[:, 0]
    if kind == "dgt":
        jt, pt = JT.DGT(n_fft=N_FFT, hop_length=HOP), PT.DGT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    else:
        jt, pt = JT.STFT(n_fft=N_FFT, hop_length=HOP), PT.STFT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    mag = np.abs(np.asarray(jt.forward(jnp.asarray(x))))
    yj = np.asarray(jt.get_sinebank_inversion(jnp.asarray(mag), key=jax.random.PRNGKey(9)))
    phi = jax_angles((-(-F // 64) * 64,), seed=9)[:F]    # JAX draws for the bins padded to the block
    yp = t2n(pt.invert(torch.as_tensor(mag), inversion_mode="sinebank", angles=torch.as_tensor(phi)))
    assert yp.shape == yj.shape == (2, HOP * mag.shape[-2] + N_FFT)
    assert rel_l2(yp, yj) <= 1e-5
    o = oracle(mag, phi, N_FFT, HOP)
    assert rel_l2(yp, o) <= 1.25 * rel_l2(yj, o)
    # the block only bounds memory; a draw from a generator is reproducible
    yb = t2n(pt.get_sinebank_inversion(torch.as_tensor(mag), angles=torch.as_tensor(phi), bin_block=100))
    assert rel_l2(yb, yp) <= 1e-6
    a = pt.invert(torch.as_tensor(mag), inversion_mode="sinebank", generator=torch.Generator().manual_seed(2))
    b = pt.invert(torch.as_tensor(mag), inversion_mode="sinebank", generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and a.abs().max() == 1


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_sinebank_stream_chunks_vs_jax(kind):
    """Three chunks of ``step_invert``: JAX's drawn phases carried across,
    each chunk within 1e-4, the clock bit-equal after each."""
    cls = "RealtimeDGT" if kind == "dgt" else "RealtimeSTFT"
    jr = getattr(JT, cls)(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank")
    pr = getattr(PT, cls)(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank", device="cpu")
    js = jr.init_state((2,), key=jax.random.PRNGKey(5), mode="sinebank")
    (ps,) = load_jax_stream_state(pr, [jax.tree_util.tree_map(np.asarray, js)])
    rng = np.random.default_rng(1)
    for i in range(3):
        m = rng.random((2, 16, F), dtype=np.float32)
        js, yj = jr.step_invert(js, jnp.asarray(m), "sinebank")
        ps, yp = pr.step_invert(ps, torch.as_tensor(m), "sinebank")
        assert yp.shape == (2, 16, N_FFT) and rel(t2n(yp), np.asarray(yj)) <= 1e-4, i
        assert np.asarray(js["time_index"]).tobytes() == t2n(ps["time_index"]).tobytes(), i


def test_load_jax_stream_state_sinebank():
    """The carry is recognised by its keys; the clock is one scalar whatever
    the batch."""
    jc = JT.OverlapAdd(N_FFT, HOP) + JT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank")
    pc = PT.OverlapAdd(N_FFT, HOP, device="cpu") + PT.RealtimeSTFT(
        n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank", device="cpu")
    st = jax.tree_util.tree_map(np.asarray, jc.init_state((3, 2), mode="sinebank"))
    got = load_jax_stream_state(pc, st)
    assert tuple(got[1]["time_index"].shape) == () and tuple(got[1]["random_phase"].shape) == (3, 2, 1, F)
    assert np.array_equal(t2n(got[1]["random_phase"]), st[1]["random_phase"])
    bad = dict(st[1], random_phase=st[1]["random_phase"][..., :1, :, :1])
    with pytest.raises(ValueError):
        load_jax_stream_state(pc, [st[0], bad])


def _chains(mode="sinebank", kind="stft", feature=False, ola_hop=HOP):
    rt = PT.RealtimeDGT if kind == "dgt" else PT.RealtimeSTFT
    c = PT.OverlapAdd(N_FFT, ola_hop, device="cpu") + rt(
        n_fft=N_FFT, hop_length=HOP, inversion_mode=mode, device="cpu")
    if feature:
        c = c + PT.Magnitude(mode=None, contrast="log1p", mel=True, n_fft=N_FFT, device="cpu")
    return c


def _g():
    return torch.Generator().manual_seed(11)


CASES = ["decode", "batched padded tail", "2-chain roundtrip", "3-chain roundtrip", "dgt decode",
         "feature decode"]


@pytest.mark.parametrize("case", CASES)
def test_closed_form_matches_generic(case):
    """The JAX test's cases at 512/128, chunks of 16 frames: ``auto`` and
    ``fused`` take the closed form on the CPU, within 5e-3 relative L2 of
    the generic scan (JAX's bound) and within 1e-5 (the same phases from the
    generator and the same clock: the angles are the same)."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(make_audio(73, batch=1, n=3 * CHUNK)[0, 0])
    chain = _chains(kind="dgt" if case == "dgt decode" else "stft", feature=case.startswith(("3-chain", "feature")))
    if case in ("decode", "dgt decode"):
        y = torch.as_tensor(rng.random((40 if case == "decode" else 24, F), dtype=np.float32))
    elif case == "batched padded tail":
        y = torch.as_tensor(rng.random((2, 21, F), dtype=np.float32))
    elif case == "feature decode":
        y, _ = PS.scan_forward(chain, x, CHUNK, backend="generic")
    if case.endswith("roundtrip"):
        assert PS.plan_roundtrip(chain, tuple(x.shape), CHUNK, "sinebank", device="cpu") == "sinebank"
        ref = PS.scan_roundtrip(chain, x, CHUNK, "sinebank", generator=_g(), backend="generic")
        outs = {b: PS.scan_roundtrip(chain, x, CHUNK, "sinebank", generator=_g(), backend=b) for b in ("auto", "fused")}
    else:
        assert PS.plan_invert(chain, tuple(y.shape), T_C, "sinebank", device="cpu") == "sinebank"
        ref = PS.scan_invert(chain, y, T_C, "sinebank", generator=_g(), backend="generic")
        outs = {b: PS.scan_invert(chain, y, T_C, "sinebank", generator=_g(), backend=b) for b in ("auto", "fused")}
    for b, out in outs.items():
        assert out.shape == ref.shape and torch.isfinite(out).all(), b
        e = rel_l2(t2n(out), t2n(ref))
        assert e < 5e-3 and e < 1e-5, b


def test_closed_form_clock_is_accumulated(monkeypatch):
    """The closed form's chunk starts are the scan's clock, accumulated in
    float32 step by step.  A direct ``i d`` product of the chunk starts
    passes JAX's 5e-3 bound on 16 chunks but misses the 1e-5 one: the bound
    that catches a detuned clock."""
    chain = _chains()
    y = torch.as_tensor(np.random.default_rng(4).random((1, 64, F), dtype=np.float32))
    ref = t2n(PS.scan_invert(chain, y, 4, "sinebank", generator=_g(), backend="generic"))
    good = rel_l2(t2n(PS.scan_invert(chain, y, 4, "sinebank", generator=_g())), ref)
    monkeypatch.setattr(PS, "_sinebank_clock", lambda n, d: np.arange(n, dtype=np.float32) * np.float32(d))
    bad = rel_l2(t2n(PS.scan_invert(chain, y, 4, "sinebank", generator=_g())), ref)
    assert good < 1e-5 < bad < 5e-3


def test_closed_form_parity_with_the_jax_scan():
    """The port's closed form against the JAX package's generic scan of the
    same magnitudes, its drawn phases carried in as the first chunk's state:
    the port's scan and closed form draw the same phases from one generator,
    so holding the JAX scan to the port's scan holds it to the closed form."""
    jc = JT.OverlapAdd(N_FFT, HOP) + JT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank")
    pc = _chains()
    mag = np.random.default_rng(6).random((2, 40, F), dtype=np.float32)
    js = jc.init_state((2,), mode="sinebank")
    ps = load_jax_stream_state(pc, jax.tree_util.tree_map(np.asarray, js))
    outs_j, outs_p = [], []
    for i in range(0, 40, T_C):
        m = mag[:, i: i + T_C]
        js, oj = jc.step_invert(js, jnp.asarray(m), "sinebank")
        ps, op = pc.step_invert(ps, torch.as_tensor(m), "sinebank")
        outs_j.append(np.asarray(oj))
        outs_p.append(t2n(op))
    assert rel_l2(np.concatenate(outs_p, -1), np.concatenate(outs_j, -1)) <= 1e-4


def test_layout_mismatch():
    """An OverlapAdd whose hop disagrees with the transform's: ``auto`` runs
    the generic scan, ``fused`` raises (the closed form overlap-adds with the
    transform's hop)."""
    chain = _chains(ola_hop=2 * HOP)
    shape = (2, 40, F)
    assert PS.plan_invert(chain, shape, T_C, "sinebank", device="cpu") == "generic"
    assert PS.plan_invert(chain, shape, T_C, "sinebank", device="cuda") == "generic"
    with pytest.raises(ValueError, match="backend='fused'"):
        PS.plan_invert(chain, shape, T_C, "sinebank", backend="fused", device="cpu")
    jc = JT.OverlapAdd(N_FFT, 2 * HOP) + JT.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, inversion_mode="sinebank")
    assert JS.plan_invert(jc, shape, T_C, "sinebank", platform="cpu") == "generic"
