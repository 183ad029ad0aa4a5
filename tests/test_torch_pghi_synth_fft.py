"""K's synthesis on the FFT route (``csrc/pghi.cu:pghi_synthesize_fft_kernel``)
as its plain version, ``ops/cuda/pghi_kernel.py:pghi_synthesize_fused_reference``,
which repeats the kernel's schedule where ``frames_fft.fft_covers(n_fft)``:
``mag * (cos, sin)(phase)``, ``frames_irfft_reference`` with pair stride
``overlap`` over the whole clip (frames ``f`` and ``f + overlap`` for ``f mod
2 overlap < overlap``), ``overlap_add_classes``, the envelope division.

* against the JAX package's Pallas kernel in interpret mode (synthesis alone
  and the whole inversion, silent-bin phases pinned) at 256/64, 512/128 and
  1024/256: 1e-4 max-abs over max-abs (float32 in another order; the TPU
  kernel's products are bf16x3);
* against a float64 ``istft`` oracle: 1e-5, on unwrapped phases up to 1e4
  rad, an odd frame count whose last pair group has zero partners, silent
  frames and a silent clip (float32 sums over 2.5 n log2 n terms; the float32
  ``cos`` / ``sin`` of a 1e4 rad argument are within an ulp of the float64
  ones of the same float32 value);
* the same result whatever block the card cuts the clip into (a block-by-block
  emulation of the kernel, halo and partners included, bit for bit);
* the product route at 1408/352, no route counted on the CPU, the block plans.

On the card ``chip_smoke.py`` holds the kernel against this plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import pghi_kernel as JK
from acids_transforms_tpu_torch.ops import windows as pwin
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PK
from acids_transforms_tpu_torch.ops.framing import overlap_add
from test_torch_common import jax_angles, rel, t2n, tones


def _dgt(n_fft, hop, x, seed=3):
    dgt = JT.DGT(n_fft=n_fft, hop_length=hop)
    mag = np.array(jnp.abs(dgt.forward(jnp.asarray(x))))
    ang = jax_angles(mag.shape, seed)
    return dgt, mag, ang, torch.as_tensor(np.array(dgt.inv_window)), pwin.dgt_gamma(n_fft)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (512, 128), (1024, 256)])
def test_fft_plain_vs_pallas_kernel(n_fft, hop):
    assert FF.fft_covers(n_fft)
    dgt, mag, ang, w, g = _dgt(n_fft, hop, tones(9000, [(220, 440), (330,)]), seed=n_fft)
    ref = np.asarray(JK.pghi_synthesize_fused(jnp.asarray(mag), jnp.asarray(ang), n_fft, hop,
                                              dgt.inv_window, interpret=True))
    got = PK.pghi_synthesize_fused(torch.as_tensor(mag), torch.as_tensor(ang), n_fft, hop, w)
    assert tuple(got.shape) == ref.shape and rel(t2n(got), ref) <= 1e-4
    ref_i = np.asarray(JK.pghi_invert_fused(jnp.asarray(mag), dgt.gamma, n_fft, hop, dgt.inv_window,
                                            tolerance=1e-2, angles=jnp.asarray(ang), interpret=True))
    got_i = PK.pghi_invert_fused(torch.as_tensor(mag), g, n_fft, hop, w, 1e-2, angles=torch.as_tensor(ang))
    assert tuple(got_i.shape) == ref_i.shape and rel(t2n(got_i), ref_i) <= 1e-4


def _oracle(mag, ph, n_fft, hop, w):
    """float64 ``istft`` of ``mag * e^{i phase}`` (the phases as float32 values)."""
    z = torch.polar(mag.double(), ph.double())
    return torch.istft(z.transpose(-2, -1), n_fft, hop, window=w.double(), center=True)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 64)])
def test_fft_plain_vs_float64_oracle(n_fft, hop):
    ov = n_fft // hop
    rng = np.random.default_rng(n_fft + hop)
    T = 2 * ov * 5 + ov - 1              # odd; the last group's frames have no partner
    assert T % 2 == 1 and 0 < T % (2 * ov) <= ov
    w = pwin.gaussian_dgt_window(n_fft, device="cpu")
    mag = torch.as_tensor(rng.random((3, T, n_fft // 2 + 1)).astype(np.float32))
    mag[0, 4:9] = 0.0                     # silent frames
    mag[1] = 0.0                          # a silent clip
    # unwrapped phases, up to 1e4 rad
    ph = torch.as_tensor((1e4 * rng.random(mag.shape)).astype(np.float32))
    assert ph.abs().max() > 9e3
    got = PK.pghi_synthesize_fused(mag, ph, n_fft, hop, w)
    ora = _oracle(mag, ph, n_fft, hop, w)
    assert got.shape == ora.shape and torch.isfinite(got).all()
    assert rel(got.double().numpy(), ora.numpy()) <= 1e-5
    assert not got[1].any()
    # the FFT route's schedule, spelled out
    y = FF.overlap_add_classes(FF.frames_irfft_reference(mag * torch.cos(ph), mag * torch.sin(ph),
                                                         FF.irfft_window(w, n_fft), stride=ov), hop)
    assert torch.equal(got, PK._finish_audio(y, w, T, n_fft, hop, None, (3,)))


@pytest.mark.parametrize("rows", [None, 2 * 4, 6 * 4])
def test_fft_schedule_does_not_depend_on_the_block(rows):
    """The kernel's blocks, emulated: a block owns ``rows`` output chunks from
    ``c0`` (a multiple of 2 overlap) and synthesizes the frames ``c0 - 2
    overlap .. c0 + rows - 1`` with frames_irfft's pairs of its own numbering,
    which are the clip's, adding the frames of class ``f mod overlap`` in
    class order into its samples.  Bit for bit the whole-clip plain version,
    at the plan's block height and two others."""
    n_fft, hop = 1024, 256
    ov = n_fft // hop
    rows = rows or PK._synth_fft_plan(n_fft, hop)[0]
    rng = np.random.default_rng(7)
    T = 45
    mag = torch.as_tensor(rng.random((2, T, n_fft // 2 + 1)).astype(np.float32))
    ph = torch.as_tensor((300 * rng.random(mag.shape)).astype(np.float32))
    w = pwin.gaussian_dgt_window(n_fft, device="cpu")
    wsyn = FF.irfft_window(w, n_fft)
    re, im = mag * torch.cos(ph), mag * torch.sin(ph)
    n_chunks = T + ov - 1
    y = torch.zeros((2, n_chunks * hop))
    for c0 in range(0, n_chunks, rows):
        f0 = c0 - 2 * ov
        idx = torch.arange(f0, min(c0 + rows, T))
        keep = idx >= 0
        lre = torch.where(keep[:, None], re[:, idx.clamp_min(0)], 0.0)
        lim = torch.where(keep[:, None], im[:, idx.clamp_min(0)], 0.0)
        frames = FF.frames_irfft_reference(lre, lim, wsyn, stride=ov)
        samples = torch.zeros((2, rows * hop))
        for c in range(ov):                              # class order
            for r in range(c, frames.shape[1], ov):
                f = f0 + r
                if f < 0:
                    continue
                lo, hi = (f - c0) * hop, (f - c0) * hop + n_fft
                a, b = max(lo, 0), min(hi, rows * hop)
                if a < b:
                    samples[:, a:b] = samples[:, a:b] + frames[:, r, a - lo: b - lo]
        n_out = min(rows, n_chunks - c0) * hop
        y[:, c0 * hop: c0 * hop + n_out] = samples[:, :n_out]
    whole = FF.overlap_add_classes(FF.frames_irfft_reference(re, im, wsyn, stride=ov), hop)
    assert torch.equal(y, whole)


def test_product_route_at_768_192():
    """The product route, at 1408/352 (2^7 11; 768/192 takes the smooth
    route, 896/224 its radix-7 instance)."""
    n_fft, hop = 1408, 352
    assert PK.synth_route(n_fft, hop) == "product" and PK.pghi_fused_available(n_fft, hop)
    dgt, mag, ang, w, _ = _dgt(n_fft, hop, tones(9000, [(220,), (440, 660)]))
    m, a = torch.as_tensor(mag), torch.as_tensor(ang)
    got = PK.pghi_synthesize_fused(m, a, n_fft, hop, w)
    # the window-folded inverse DFT as two products and one overlap-add
    Aw, Bw = PK._windowed_idft(w, n_fft)
    y = overlap_add(torch.matmul(m * torch.cos(a), Aw) + torch.matmul(m * torch.sin(a), Bw), hop)
    assert torch.equal(got, PK._finish_audio(y, w, m.shape[1], n_fft, hop, None, (2,)))
    ref = np.asarray(JK.pghi_synthesize_fused(jnp.asarray(mag), jnp.asarray(ang), n_fft, hop,
                                              dgt.inv_window, interpret=True))
    assert rel(t2n(got), ref) <= 1e-4


def test_no_route_counted_on_the_cpu():
    PK.reset_launches()
    w = pwin.gaussian_dgt_window(512, device="cpu")
    mag = torch.rand(2, 20, 257)
    PK.pghi_synthesize_fused(mag, torch.rand(2, 20, 257), 512, 128, w)
    PK.pghi_invert_fused(mag, pwin.dgt_gamma(512), 512, 128, w)
    assert set(PK.routes) == {"pghi_synthesize:fft", "pghi_synthesize:smooth", "pghi_synthesize:product"}
    assert not any(PK.routes.values()) and not any(PK.launches.values())


def test_fft_plans():
    # the main shape: 56 chunks and 4 FFTs, two blocks an SM
    assert PK._synth_fft_plan(1024, 256) == (56, 4)
    assert PK._synth_fft_smem_bytes(56, 256, 1024, 4) <= FF.TWO_BLOCKS_SMEM
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        for hop in range(4, n_fft, 4):
            if n_fft % hop or not PK.pghi_fused_available(n_fft, hop):
                continue
            rows, teams = PK._synth_fft_plan(n_fft, hop)
            ov = n_fft // hop
            assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_max_teams(n_fft)
            assert PK._synth_fft_smem_bytes(rows, hop, n_fft, teams) <= FF.MAX_SMEM
