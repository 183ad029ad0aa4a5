"""Two dispatch rules of the port held against the JAX package's.

* Offline PGHI (``STFT.invert`` in ``pghi`` / ``pghi_bidir`` / ``pghi_gl``,
  ``STFT.pghi``): on a CUDA tensor the eager formulation runs only where the
  JAX package's structural gates (``ops/pallas/pghi_kernel.py:
  pghi_phases_available`` / ``pghi_fused_available``) refuse the shape and
  the port's kernels cannot take it either
  (``ops/cuda/pghi_kernel.py:pghi_dispatch``); streaming sessions likewise
  take the JAX package's overlap-add layouts and the layouts their kernels
  cover, so a hop like 250 streams through the generic scan and 1200/300
  through the session kernels.  A shape inside the JAX gates but beyond a
  kernel's limit raises ``NotImplementedError``.
* The full-K Griffin-Lim step (kernel J): blocks that hold a slab of the
  frames' synthesis rows where the whole rows do not fit shared memory
  (n_fft 4096 at overlap 8, n_fft 8192), and the short clip's repeated
  reflection; its plain version against the eager loop there (one
  ``istft`` + ``stft`` a step, within 1e-5 of the largest value: the same
  float32 operations in another order, the gaussian window >= 0.01).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import ola as jola
from acids_transforms_tpu.ops.pallas import pghi_kernel as JPK
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops import griffinlim as pgl
from acids_transforms_tpu_torch.ops.cuda import glstep as pk
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PPK
from acids_transforms_tpu_torch.ops.cuda import stream_step as PSS
from acids_transforms_tpu_torch.ops.fft import istft, stft
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window
from test_torch_common import jax_angles, make_audio, rel, t2n, tones

SHAPES = [
    (1024, 256), (1024, 300), (1000, 250), (1026, 342), (512, 64), (768, 192), (640, 160),
    (1024, 160), (512, 512), (16384, 4096), (256, 2), (384, 6), (2048, 512), (4096, 1024),
    (1200, 300), (1024, 128), (8192, 2048), (960, 240), (1536, 96),
]


@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_pghi_dispatch_follows_the_jax_gates(n_fft, hop):
    """The kernels run where they cover the shape or the JAX package's gate
    holds; a route the JAX package refuses runs eagerly only where the port's
    kernel cannot take the shape either."""
    fused, phases = JPK.pghi_fused_available(n_fft, hop), JPK.pghi_phases_available(n_fft, hop)
    covers = PPK.pghi_fused_available(n_fft, hop)
    assert PPK.ola_supported(n_fft, hop) == jola.ola_supported(n_fft, hop)
    for mode in ("pghi", "pghi_bidir"):
        want = "fused" if fused or covers else "phases" if phases else "eager"
        assert PPK.pghi_dispatch(mode, n_fft, hop) == want
    assert PPK.pghi_dispatch("phases", n_fft, hop) == ("phases" if phases else "eager")


def test_kernel_covered_shapes_stay_on_the_kernels():
    """Shapes whose overlap-add layout the JAX package refuses but the port's
    kernels take (``hop % 4 == 0``, ``hop | n_fft``) keep the kernels: the
    offline PGHI synthesis and every streaming session at 1200/300 and
    960/240; hop 250 (``hop % 4 != 0``) keeps neither."""
    for n_fft, hop in ((1200, 300), (960, 240), (800, 200), (1000, 200)):
        assert not jola.ola_supported(n_fft, hop) and not JPK.pghi_fused_available(n_fft, hop)
        assert PPK.pghi_dispatch("pghi", n_fft, hop) == "fused"
        PPK._require_synthesis(n_fft, hop)
        jc = JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop)
        pc = (PT.OverlapAdd(n_fft, hop, device="cpu")
              + PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu"))
        chunk = 8 * hop
        assert not JK.fused_roundtrip_available(jc, chunk)
        for mode in (None, "random", "pghi", "pghi_gl"):
            want = "complex" if mode is None else mode
            assert PS.plan_roundtrip(pc, (2, 4 * chunk), chunk, mode, device="cuda") == want
            fc = pc + PT.Magnitude(mode="unipolar", contrast="log1p", mel=False, n_fft=n_fft, device="cpu")
            if mode is not None:
                assert PS.plan_roundtrip(fc, (2, 4 * chunk), chunk, mode, device="cuda") == want
                assert PS.plan_invert(pc, (2, 32, n_fft // 2 + 1), 8, mode, device="cuda") == want
        assert PS.plan_forward(pc, (2, 4 * chunk), chunk, device="cuda") == "fused"
        assert PS.plan_invert(pc, (2, 32, n_fft // 2 + 1), 8, y_is_complex=True, device="cuda") == "complex"
    assert PPK.pghi_dispatch("pghi", 1000, 250) == "phases"


def test_kernel_limits_inside_the_gates_raise_not_implemented():
    """Inside the structure a kernel's own limit raises NotImplementedError
    (before anything touches a card); outside it the launch is a caller's
    error."""
    m = torch.zeros(1, 4, 8193)
    with pytest.raises(NotImplementedError, match="4096"):
        PPK._launch_phases(m, m, 1.0, 16384, 4096, 1e-2, False)
    with pytest.raises(ValueError, match="does not cover"):
        PPK._launch_phases(torch.zeros(1, 4, 513), m, 1.0, 1024, 300, 1e-2, False)
    with pytest.raises(NotImplementedError, match="hop % 4"):
        PPK._require_synthesis(256, 2)                  # a supported layout, hop % 4 != 0
    with pytest.raises(ValueError, match="does not cover"):
        PPK._require_synthesis(1026, 342)               # no supported layout
    PPK._require_synthesis(1024, 256)
    with pytest.raises(ValueError, match="unknown"):
        PPK.pghi_dispatch("pghi_gl", 1024, 256)


def test_offline_pghi_outside_the_gates_is_the_eager_inversion():
    """``STFT(1024, 300)`` in ``pghi``: the eager route (``pghi_scan`` and
    the ISTFT), as the JAX package inverts it, within 1e-4."""
    x = make_audio(3, batch=1, n=8000)[:, 0]
    js, ps = JT.STFT(n_fft=1024, hop_length=300), PT.STFT(n_fft=1024, hop_length=300, device="cpu")
    assert PPK.pghi_dispatch("pghi", 1024, 300) == "eager"
    mag = t2n(ps(torch.as_tensor(x)).abs())
    ref = np.array(js.invert(jnp.asarray(mag), inversion_mode="pghi"))
    got = ps.invert(torch.as_tensor(mag), inversion_mode="pghi", angles=torch.as_tensor(jax_angles(mag.shape, 0)))
    assert got.shape == ref.shape and rel(t2n(got), ref) <= 1e-4


def test_streaming_sends_unsupported_layouts_to_the_generic_scan():
    """``OverlapAdd(1000, 250) + RealtimeSTFT(1000, 250)`` has no overlap-add
    layout in the JAX package, which streams it through the chunk scan: the
    port's plans do the same on the card, and ``fused`` refuses it."""
    jc = JT.OverlapAdd(1000, 250) + JT.RealtimeSTFT(n_fft=1000, hop_length=250)
    pc = PT.OverlapAdd(1000, 250, device="cpu") + PT.RealtimeSTFT(n_fft=1000, hop_length=250, device="cpu")
    assert not JK.fused_roundtrip_available(jc, 2000) and not PSS.fused_roundtrip_available(pc, 2000)
    for mode in (None, "random", "pghi", "pghi_gl"):
        assert PS.plan_roundtrip(pc, (2, 8000), 2000, mode, device="cuda") == "generic"
        with pytest.raises(ValueError, match="backend='fused'"):
            PS.plan_roundtrip(pc, (2, 8000), 2000, mode, backend="fused", device="cuda")
    assert PS.plan_forward(pc, (2, 8000), 2000, device="cuda") == "generic"
    assert PS.plan_invert(pc, (2, 40, 501), 8, "pghi", device="cuda") == "generic"
    # the generic scan streams it: the complex roundtrip at unity gain after the delay
    x = torch.as_tensor(tones(8000, [(220, 440)]))
    y = PS.scan_roundtrip(pc, x, 2000)
    d = 1000 - 250
    assert rel(t2n(y)[:, d:7000], t2n(x)[:, : 7000 - d]) <= 1e-4
    # the shapes the kernels take are unchanged
    ok = PT.OverlapAdd(1024, 256, device="cpu") + PT.RealtimeSTFT(n_fft=1024, hop_length=256, device="cpu")
    assert PSS.fused_roundtrip_available(ok, 4096)
    assert PS.plan_roundtrip(ok, (2, 8192), 4096, "pghi_gl", device="cuda") == "pghi_gl"


def test_full_k_blocks_cover_the_wide_shapes():
    """Where the whole ``[re | im]`` rows fit, J's block is the unslabbed one; at n_fft
    4096 / overlap 8 and n_fft 8192 the rows are built in slabs; a short
    clip's reflection must lie in one block."""
    for (n_fft, hop), want in {(1024, 256): (32, 28, 1056), (2048, 256): (15, 7, 2080),
                               (4096, 1024): (7, 3, 4128), (4096, 512): (32, 24, 832),
                               (8192, 2048): (15, 11, 1056)}.items():
        got = pk._pick_fullk_block(n_fft, hop)
        assert got == want, (n_fft, hop, got)
        rows, tile_t, slab = got
        assert slab % 32 == 0 and pk._fullk_smem_bytes(rows, n_fft // hop, hop, slab) <= pk.MAX_SMEM
        assert pk._pick_fullk_rows(n_fft, hop) == ((rows, tile_t) if slab == PPK._k_padded(n_fft // 2 + 1)
                                                   else None)
    assert pk._fullk_reflection_covered(3, 1024, 256, 32, 28)        # L = n_fft / 2: reflects twice
    assert pk._fullk_reflection_covered(200, 1024, 256, 32, 28)      # one reflection
    assert not pk._fullk_reflection_covered(1, 1024, 256, 32, 28)    # no trimmed signal
    assert not pk._fullk_reflection_covered(3, 1024, 256, 32, 2)     # frames over two blocks


def _one_step(mag, n_fft, hop, w, seed):
    """J's plain step and one iteration of the eager loop from the same
    state: their projections ``(rre, rim)`` and the eager ``stft(istft)``."""
    g = torch.Generator().manual_seed(seed)
    ph = 2 * np.pi * torch.rand(mag.shape, generator=g)
    are, aim = torch.cos(ph), torch.sin(ph)
    zeros = torch.zeros_like(are)
    step, to_rows, _ = pk.make_gl_momentum_step_fullk(mag, n_fft, hop, w, 0.5)
    out = step(*[to_rows(a) for a in (are, aim, zeros, zeros)])
    eager = stft(istft(torch.complex(mag * are, mag * aim), n_fft, hop, w), n_fft, hop, w)
    return out, eager


@pytest.mark.parametrize("n_fft,hop,n", [(512, 128, 257), (1024, 256, 513), (4096, 512, 20000)])
def test_full_k_plain_step_matches_the_eager_loop(n_fft, hop, n):
    """J's plain version, one step: a 3-frame clip (the trimmed signal as
    long as half a frame, so the padding reflects twice) at 512/128 and
    1024/256, and a clip at 4096/512, against the eager loop's ``istft`` +
    ``stft``; then 3 iterations through ``griffin_lim(fused=True)`` converge
    as the eager loop does."""
    w = gaussian_dgt_window(n_fft)
    x = torch.as_tensor(make_audio(9, batch=2, n=n)[:, 0])
    mag = stft(x, n_fft, hop, w).abs()
    assert mag.shape[1] == (3 if n < n_fft else mag.shape[1])
    (nare, naim, rre, rim), eager = _one_step(mag, n_fft, hop, w, 1)
    scale = eager.abs().max().item()
    assert max((rre - eager.real).abs().max().item(), (rim - eager.imag).abs().max().item()) <= 1e-5 * scale
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    y_k = pgl.griffin_lim(mag, n_fft, hop, w, n_iter=3, generator=g1, fused=True)
    y_e = pgl.griffin_lim(mag, n_fft, hop, w, n_iter=3, generator=g2, fused=False)
    assert y_k.shape == y_e.shape and rel(t2n(y_k), t2n(y_e)) <= 1e-4


def test_irfft_drops_the_imaginary_part_at_dc_and_nyquist():
    """``irfft_frames(impl="fft")`` computes the inverse of a real signal's
    spectrum, which has no imaginary part at DC and nyquist: the port drops
    it, as numpy and XLA do (cuFFT's C2R leaves the result undefined there,
    which moved the eager ISTFT at n_fft 8192 on the card)."""
    from acids_transforms_tpu_torch.ops.fft import irfft_frames

    rng = np.random.default_rng(2)
    spec = torch.complex(*(torch.as_tensor(rng.standard_normal((2, 3, 4097)).astype(np.float32)) for _ in range(2)))
    got = irfft_frames(spec, 8192, impl="fft")
    ref = np.fft.irfft(t2n(spec).astype(np.complex128), n=8192)
    assert got.shape == (2, 3, 8192) and rel(t2n(got), ref) <= 1e-5
    edge = spec.clone()
    edge.imag[..., 0] = 0
    edge.imag[..., -1] = 0
    assert torch.equal(irfft_frames(edge, 8192, impl="fft"), got)
