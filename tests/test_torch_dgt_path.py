"""The DGT slice as a whole at a small size (n_fft 512, hop 128, 3 clips):
``fuse_fit`` -> ``fuse_forward`` -> ``invert`` of ``Mono + DGT + Magnitude``
in the port against the JAX chain, on the CPU, where the port's kernel
wrappers run their plain versions (E, F: full-K forward and statistics; K:
PGHI phases and synthesis).

Tolerances.  Forward and fitted statistics: 1e-4 (the JAX kernel's own
budget).  Inverted audio with the silent-bin phases pinned: the JAX chain
runs its sqrt-blocked scan off-TPU and the port the serial one, which differ
in the order of a few additions on unwrapped float32 phases (up to 7e3 rad
here, one ulp 5e-4), so the audio is held to 2e-2 of its peak and the
spectral convergence to the repo's margin ``max(1.15 s, s + 0.02)``
(``tests/test_gl_parity.py``); against the JAX *serial* scan the audio is
held to 1e-4.  Unpinned or differently ordered modes: spectral convergence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu as jatt
import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch as patt
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops import pghi as JP
from acids_transforms_tpu.ops.fft import istft as jistft
from test_torch_common import HOP, N_FFT, carry_over, dgt_chains, jax_angles, make_audio, rel, t2n

TOL = 1e-4


@pytest.fixture(scope="module")
def path():
    """Audio, the JAX chain fitted by its Pallas statistics kernel, the port
    chain with that state, and the JAX forward output."""
    jc, pc = dgt_chains()
    x = make_audio(41, batch=3, n=9000)
    jf = jatt.fuse_fit(jc, backend="pallas")(jnp.asarray(x))
    carry_over(jf, pc)
    y = np.asarray(jatt.fuse_forward(jf, backend="pallas")(jnp.asarray(x)))
    return x, jf, pc, y


def spectral_convergence(audio, target):
    """``|| |DGT(audio)| - target || / || target ||`` with the JAX transform."""
    dgt = JT.DGT(n_fft=N_FFT, hop_length=HOP)
    R = np.abs(np.asarray(dgt.forward(jnp.asarray(np.asarray(audio, np.float32)))))
    n = min(R.shape[-2], target.shape[-2])
    return float(np.linalg.norm(R[..., :n, :] - target[..., :n, :]) / np.linalg.norm(target))


def test_fused_fit_offset_and_scale(path):
    x, jf, _, _ = path
    _, fresh = dgt_chains()
    assert patt.fuse.fit_fusable(fresh) and patt.fuse.fusable(fresh, "kernel")
    pf = patt.fuse_fit(fresh, backend="kernel")(torch.as_tensor(x))
    j_off, j_scl = float(jf[2].norm.offset), float(jf[2].norm.scale)
    assert abs(float(pf[2].norm.offset) - j_off) <= TOL * j_scl
    assert abs(float(pf[2].norm.scale) - j_scl) <= TOL * j_scl
    assert not pf[2].norm.needs_scaling and fresh[2].norm.needs_scaling
    pe = fresh.fit(torch.as_tensor(x))               # the eager cascade agrees
    assert abs(float(pe[2].norm.scale) - float(pf[2].norm.scale)) <= 1e-5 * j_scl
    assert abs(float(pe[2].norm.offset) - float(pf[2].norm.offset)) <= 1e-5 * j_scl


@pytest.mark.parametrize("backend", ["kernel", "eager", "auto"])
def test_forward_vs_jax_chain(path, backend):
    x, _, pc, y = path
    yp = patt.fuse_forward(pc, backend=backend)(torch.as_tensor(x))
    assert tuple(yp.shape) == y.shape == (3, 71, 257) and rel(t2n(yp), y) <= TOL
    assert rel(t2n(pc.forward(torch.as_tensor(x))), y) <= TOL
    pcm = np.round(x.mean(1) * 32767).astype(np.int16)
    a = patt.fuse_forward(pc, backend=backend)(torch.as_tensor(pcm))
    b = patt.fuse_forward(pc, backend=backend)(torch.as_tensor(pcm.astype(np.float32) * 2.0 ** -15))
    assert torch.equal(a, b)                         # int16 PCM: bit-identical to pre-converted


def test_complex_roundtrip_is_exact(path):
    x, _, pc, _ = path
    xm = pc[0].forward(torch.as_tensor(x))
    back = pc[1].invert(pc[1].forward(xm))
    assert rel(t2n(back), t2n(xm)[..., : back.shape[-1]]) <= TOL


@pytest.mark.parametrize("mode", ["pghi", "pghi_bidir"])
def test_invert_pghi_pinned_vs_jax_chain(path, mode):
    _, jf, pc, y = path
    rj = np.asarray(jf.invert(jnp.asarray(y), inversion_mode=mode))       # off-TPU: the blocked scan
    mag = pc[2].invert(torch.as_tensor(y))
    ang = torch.as_tensor(jax_angles(tuple(mag.shape)))                   # the JAX scan's own draw
    rp = pc[0].invert(pc[1].invert(mag, inversion_mode=mode, angles=ang))
    assert tuple(rp.shape) == rj.shape == (3, 1, 8960) and torch.isfinite(rp).all()
    assert rel(t2n(rp), rj) <= 2e-2
    target = t2n(mag)
    s_j, s_p = spectral_convergence(rj[:, 0], target), spectral_convergence(t2n(rp)[:, 0], target)
    assert s_p < max(1.15 * s_j, s_j + 0.02) and s_p < 0.3
    # against the JAX serial scan + ISTFT the audio agrees to the kernel's budget
    jd = jf[1]
    ph = JP.pghi_scan(jnp.asarray(target), jd.gamma, N_FFT, HOP, tolerance=jd.tolerance,
                      parallel=False, key=jax.random.PRNGKey(0), time_stencil="central")
    serial = np.asarray(jistft(jnp.asarray(target) * jnp.exp(1j * ph), N_FFT, HOP, jd.inv_window))
    assert rel(t2n(rp)[:, 0], serial) <= TOL
    # the whole chain through chain.invert (own generator): same quality
    whole = pc.invert(torch.as_tensor(y), inversion_mode=mode)
    assert spectral_convergence(t2n(whole)[:, 0], target) < max(1.15 * s_j, s_j + 0.02)


def test_invert_pghi_exact_vs_jax_chain(path):
    _, jf, pc, y = path
    rj = np.asarray(jf.invert(jnp.asarray(y), inversion_mode="pghi_exact"))
    rp = pc.invert(torch.as_tensor(y), inversion_mode="pghi_exact")
    assert rel(t2n(rp), rj) <= TOL                   # the heap is deterministic: pinned by nature


def test_invert_pghi_gl_vs_jax_chain(path):
    _, jf, pc, y = path
    rj = np.asarray(jf.invert(jnp.asarray(y), inversion_mode="pghi_gl"))
    mag = pc[2].invert(torch.as_tensor(y))
    ang = torch.as_tensor(jax_angles(tuple(mag.shape)))
    rp = pc[0].invert(pc[1].invert(mag, inversion_mode="pghi_gl", angles=ang))
    target = t2n(mag)
    s_j, s_p = spectral_convergence(rj[:, 0], target), spectral_convergence(t2n(rp)[:, 0], target)
    s_pghi = spectral_convergence(t2n(pc[1].invert(mag, inversion_mode="pghi", angles=ang)), target)
    assert s_p < max(1.15 * s_j, s_j + 0.02)
    assert s_p < s_pghi                              # the projections improve on the seed


def test_invert_random_and_keep_input(path):
    x, jf, pc, y = path
    mag = pc[2].invert(torch.as_tensor(y))
    target = t2n(mag)
    # random: same phases in both packages give the same audio
    ang = jax_angles(tuple(mag.shape), seed=9)
    rj = np.asarray(jf[1].invert(jnp.asarray(target), inversion_mode="keep_input", phase=jnp.asarray(ang)))
    rp = pc[1].invert(mag, inversion_mode="keep_input", phase=torch.as_tensor(ang))
    assert rel(t2n(rp), rj) <= TOL
    a = pc[1].invert(mag, inversion_mode="random", generator=torch.Generator().manual_seed(3))
    b = pc[1].invert(mag, inversion_mode="random", generator=torch.Generator().manual_seed(3))
    c = pc[1].invert(mag, inversion_mode="random")
    d = pc[1].invert(mag, inversion_mode="random")
    assert torch.equal(a, b) and not torch.equal(c, d)            # seeded, and draws advance
    s_rand = spectral_convergence(t2n(a), target)
    s_jrand = spectral_convergence(np.asarray(jf[1].invert(jnp.asarray(target), inversion_mode="random")), target)
    assert s_rand < max(1.15 * s_jrand, s_jrand + 0.02)
    # keep_input: the phase of the last forward of the same shape comes back
    xm = pc[0].forward(torch.as_tensor(x))
    spec = pc[1].forward(xm)
    kept = pc[1].invert(spec.abs(), inversion_mode="keep_input")
    assert rel(t2n(kept), t2n(xm)[..., : kept.shape[-1]]) <= 1e-3
    other = pc[1].invert(spec.abs()[:, :40], inversion_mode="keep_input")      # no stash of that shape: random
    assert other.shape[-1] == 39 * HOP and torch.isfinite(other).all()


def test_sinebank_and_realtime_still_raise(path):
    """The DGT inherits ``sinebank``: through the chain, and on the DGT child
    with the JAX package's phases against its ``get_sinebank_inversion``
    (1e-3 relative L2); its ``realtime()`` twin streams it eagerly, the JAX
    transform's drawn phases carried over (1e-4, the clock bit-equal)."""
    _, jf, pc, y = path
    out = pc.invert(torch.as_tensor(y), inversion_mode="sinebank")
    assert tuple(out.shape) == tuple(jf.invert(jnp.asarray(y), inversion_mode="sinebank").shape) == (3, 1, HOP * 71 + N_FFT)
    assert torch.isfinite(out).all()
    mag = np.asarray(jf[2].invert(jnp.asarray(y)))
    key = jax.random.PRNGKey(4)
    yj = np.asarray(jf[1].get_sinebank_inversion(jnp.asarray(mag), key=key))
    phi = jax_angles((-(-mag.shape[-1] // 64) * 64,), seed=4)[: mag.shape[-1]]
    yp = t2n(pc[1].invert(torch.as_tensor(mag), inversion_mode="sinebank", angles=torch.as_tensor(phi)))
    assert np.linalg.norm(yp - yj) / np.linalg.norm(yj) <= 1e-3
    rt = pc[1].realtime()
    assert isinstance(rt, PT.RealtimeDGT) and rt.inversion_mode == pc[1].inversion_mode
    jrt = jf[1].realtime()
    m8 = mag[..., :8, :]
    fj = np.asarray(jrt.invert(jnp.asarray(m8), inversion_mode="sinebank"))
    rt._state = {"time_index": torch.zeros(()), "random_phase": torch.as_tensor(np.asarray(jrt._state["random_phase"]))}
    fp = t2n(rt.invert(torch.as_tensor(m8), inversion_mode="sinebank"))
    assert fp.shape == fj.shape == (3, 8, N_FFT) and rel(fp, fj) <= 1e-4
    assert np.asarray(jrt._state["time_index"]).tobytes() == t2n(rt._state["time_index"]).tobytes()


def test_stft_hann_pghi_through_window_gamma():
    """PGHI on a plain hann STFT through the window's effective gamma."""
    x = make_audio(42, batch=2, n=9000)[:, 0]
    js = JT.STFT(n_fft=N_FFT, hop_length=HOP, window="hann", inversion_mode="pghi")
    ps = PT.STFT(n_fft=N_FFT, hop_length=HOP, window="hann", inversion_mode="pghi", device="cpu")
    assert ps.gamma == js.gamma
    mag = np.abs(np.asarray(js.forward(jnp.asarray(x))))
    pj = np.asarray(js.pghi(jnp.asarray(mag)))
    ang = torch.as_tensor(jax_angles(mag.shape))
    pp = ps.pghi(torch.as_tensor(mag), angles=ang)
    sig = mag > 1e-2 * mag.max(axis=(-2, -1), keepdims=True)
    # blocked (JAX, off-TPU) vs serial order on phases up to 7e3 rad: a few ulp
    assert np.abs(t2n(pp) - pj)[sig].max() <= 2e-2
    rj = np.asarray(js.invert(jnp.asarray(mag)))
    rp = ps.invert(torch.as_tensor(mag), angles=ang)

    def sc(a):
        R = np.abs(np.asarray(js.forward(jnp.asarray(np.asarray(a, np.float32)))))
        n = min(R.shape[-2], mag.shape[-2])
        return float(np.linalg.norm(R[:, :n] - mag[:, :n]) / np.linalg.norm(mag))

    assert sc(t2n(rp)) < max(1.15 * sc(rj), sc(rj) + 0.02)


def test_gradient_through_fuse_forward(path):
    x, _, pc, _ = path
    xt = torch.as_tensor(x[:1, :, :4000]).clone().requires_grad_(True)
    patt.fuse_forward(pc, backend="kernel")(xt).square().sum().backward()
    g_kernel = xt.grad.clone()
    xt.grad = None
    pc.forward(xt).square().sum().backward()
    assert torch.isfinite(g_kernel).all() and g_kernel.abs().max() > 0
    assert rel(t2n(g_kernel), t2n(xt.grad)) <= 1e-3   # value from the kernel path, gradient of the eager twin

