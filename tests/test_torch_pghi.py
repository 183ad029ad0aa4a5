"""``ops/pghi.py`` of the port against the JAX package's on the CPU: the phase
gradients, the anchor mask, and the serial scan with the silent-bin phases
pinned to the JAX draw (``2 pi uniform(key)`` handed to the port as
``angles=``), plus the host heap.

Phases are unwrapped float32 sums, compared at 1e-3 absolute: that holds at
T <= 120 on low-pitched content, where the carrier term keeps the phases of
audible bins small (one ulp <= 1e-4).  Both scans add in the same order (the
port repeats the pairwise recursion of ``lax.associative_scan``), so in
practice they agree to a few 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops import pghi as JP
from acids_transforms_tpu_torch.ops import pghi as PP
from acids_transforms_tpu_torch.ops import windows as pwin
from test_torch_common import jax_angles, make_audio, t2n, tones


def magnitudes(n_fft, hop, x):
    dgt = JT.DGT(n_fft=n_fft, hop_length=hop)
    return dgt, np.array(jnp.abs(dgt.forward(jnp.asarray(x))))   # a writable copy


@pytest.mark.parametrize("stencil", ["central", "backward"])
def test_phase_gradients_equal_jax(stencil):
    dgt, mag = magnitudes(512, 128, make_audio(31, batch=2, n=6000)[:, 0])
    tj, fj = JP.phase_gradients(jnp.asarray(mag), dgt.gamma, 512, 128, time_stencil=stencil)
    tp, fp = PP.phase_gradients(torch.as_tensor(mag), pwin.dgt_gamma(512), 512, 128, time_stencil=stencil)
    # log of float32 magnitudes, differences divided by fmul ~ 0.2: a few ulp of |log| ~ 16
    assert np.abs(t2n(tp) - np.asarray(tj)).max() <= 1e-4
    assert np.abs(t2n(fp) - np.asarray(fj)).max() <= 1e-5
    with pytest.raises(ValueError):
        PP.phase_gradients(torch.as_tensor(mag), 1.0, 512, 128, time_stencil="forward")


def test_anchor_mask_equals_jax_exactly():
    _, mag = magnitudes(512, 128, make_audio(32, batch=3, n=7000)[:, 0])
    mag[1, 10:14] = 0.0                    # silent frames: onset seeding after them
    mag[2] = 0.0                           # an all-silent clip
    mx = mag.max(axis=(-2, -1), keepdims=True)
    abstol = np.maximum(np.float32(1e-2) * mx, np.float32(1.19e-7))[..., 0, :]
    prev = np.concatenate([np.zeros_like(mag[:, :1]), mag[:, :-1]], axis=1)
    aj, sj = JP._anchor_mask(jnp.asarray(mag), jnp.asarray(prev), jnp.asarray(abstol))
    ap, sp = PP._anchor_mask(torch.as_tensor(mag), torch.as_tensor(prev), torch.as_tensor(abstol))
    assert np.array_equal(ap.numpy(), np.asarray(aj)) and np.array_equal(sp.numpy(), np.asarray(sj))
    assert ap[0].any() and not ap[2].any() and not ap[1, 10:14].any()


@pytest.mark.parametrize("stencil", ["central", "backward"])
@pytest.mark.parametrize("n_fft,hop,n", [(512, 128, 9000), (1024, 256, 30000)])
def test_pghi_scan_equals_jax_serial_scan(stencil, n_fft, hop, n):
    x = tones(n, [(220, 440, 880), (330,), (550, 1100)])
    dgt, mag = magnitudes(n_fft, hop, x)
    assert mag.shape[1] <= 120
    key = jax.random.PRNGKey(0)
    ref = np.asarray(JP.pghi_scan(jnp.asarray(mag), dgt.gamma, n_fft, hop, tolerance=1e-2,
                                  parallel=False, key=key, time_stencil=stencil))
    got = PP.pghi_scan(torch.as_tensor(mag), pwin.dgt_gamma(n_fft), n_fft, hop, tolerance=1e-2,
                       time_stencil=stencil, angles=torch.as_tensor(jax_angles(mag.shape)))
    assert got.shape == ref.shape and np.abs(t2n(got) - ref).max() <= 1e-3
    # parallel= / block= are accepted and run the serial form
    same = PP.pghi_scan(torch.as_tensor(mag), pwin.dgt_gamma(n_fft), n_fft, hop, tolerance=1e-2,
                        time_stencil=stencil, angles=torch.as_tensor(jax_angles(mag.shape)),
                        parallel=True, block=8)
    assert torch.equal(same, got)


def test_pghi_scan_streaming_state_equals_jax():
    """``prev_mag`` / ``prev_phase``: two chunks equal one call, as in JAX."""
    x = tones(12000, [(220, 440), (330,)])
    dgt, mag = magnitudes(512, 128, x)
    g = pwin.dgt_gamma(512)
    T = mag.shape[1]
    cut = T // 2
    ang = jax_angles(mag.shape)
    kw = dict(tolerance=1e-2, time_stencil="backward")
    whole = PP.pghi_scan(torch.as_tensor(mag), g, 512, 128, angles=torch.as_tensor(ang), **kw)
    first = PP.pghi_scan(torch.as_tensor(mag[:, :cut]), g, 512, 128,
                         angles=torch.as_tensor(ang[:, :cut]), **kw)
    prev_mag, prev_phase = mag[:, cut - 2: cut], t2n(first[:, -1])
    second = PP.pghi_scan(torch.as_tensor(mag[:, cut:]), g, 512, 128,
                          prev_mag=torch.as_tensor(prev_mag), prev_phase=torch.as_tensor(prev_phase),
                          angles=torch.as_tensor(ang[:, cut:]), **kw)
    ref = np.asarray(JP.pghi_scan(jnp.asarray(mag[:, cut:]), dgt.gamma, 512, 128, parallel=False,
                                  prev_mag=jnp.asarray(prev_mag), prev_phase=jnp.asarray(prev_phase),
                                  key=jax.random.PRNGKey(0), **kw))
    # the JAX call draws angles for its own (shorter) shape: compare audible bins
    sig = mag[:, cut:] > 1e-2 * mag[:, cut:].max(axis=(-2, -1), keepdims=True)
    assert np.abs(t2n(second) - ref)[sig].max() <= 1e-3
    # (the chunks' abstol is their own maximum, so only equal-loudness chunks
    # reproduce the whole; these tones are stationary)
    sig_w = mag[:, cut:] > 1e-2 * mag.max(axis=(-2, -1), keepdims=True)
    assert np.abs(t2n(second) - t2n(whole[:, cut:]))[sig & sig_w].max() <= 1e-3


def test_generator_drives_the_silent_bins_and_no_global_seed():
    _, mag = magnitudes(512, 128, tones(5000, [(220,)]))
    m = torch.as_tensor(mag)
    g = pwin.dgt_gamma(512)
    torch.manual_seed(1)
    a = PP.pghi_scan(m, g, 512, 128, time_stencil="central")
    torch.manual_seed(2)
    b = PP.pghi_scan(m, g, 512, 128, time_stencil="central")
    assert torch.equal(a, b)               # the default generator is seeded with 0, not globally
    c = PP.pghi_scan(m, g, 512, 128, time_stencil="central",
                     generator=torch.Generator().manual_seed(5))
    silent = m <= 1e-2 * m.max()
    assert silent.any() and not torch.equal(a[silent], c[silent])
    assert torch.equal(a[~silent], c[~silent])


def test_heap_numpy_equals_jax_heap():
    _, mag = magnitudes(512, 128, make_audio(33, batch=1, n=6000)[:, 0])
    g = pwin.dgt_gamma(512)
    ref = JP.pghi_heap_numpy(mag[0], g, 512, 128, 1e-2)
    got = PP.pghi_heap_numpy(mag[0], g, 512, 128, 1e-2)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert np.array_equal(PP.pghi_heap_numpy(np.zeros((5, 257)), g, 512, 128), np.zeros((5, 257), np.float32))
