"""The streaming decodes on the FFT route: P (the random decode, also the
synthesis of N and Q), S (the complex decode) and O's projection synthesis,
``csrc/stream_step.cu:session_decode_fft_kernel`` where n_fft is a power of
two from 64 to 4096.  Their plain version,
``ops/cuda/stream_step.py:_synthesize_fft``, repeats the kernel's float32
operations in order (the frames from ``-(overlap - 1)`` on, paired ``(u, u +
overlap)``, ``frames_irfft_reference`` under the synthesis window over the
gain and n_fft, the overlap-add in class order); ``chip_smoke.py`` holds the
kernel to it on the card.

Tolerances, and why:

* against the JAX package's Pallas session kernels in interpret mode
  (512/128): 1e-3 of the largest sample for P (its products are bf16x4 on
  magnitudes with random angles, as ``test_torch_stream_kernel.py``), 1e-4
  for S;
* against a float64 oracle (``np.fft.irfft``, explicit overlap-add), the
  port's generic chunk scan and the JAX package's own projection: 1e-5
  (float32 FFT sums);
* block by block, the FFT schedule gives the whole session bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.fft import irfft_frames as j_irfft
from acids_transforms_tpu.ops.framing import overlap_add as j_ola
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.cuda.frames_fft import (
    MAX_SMEM,
    TWO_BLOCKS_SMEM,
    fft_covers,
    frames_irfft_reference,
    frames_rfft_reference,
    irfft_window,
)
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_kernel import oracle

CHUNK = 1024


def chains(n_fft, hop):
    return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop),
            PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu"))


def spectra(n_fft, hop, seed=41, batch=2, n=3 * CHUNK + 300):
    """A session's encode of seeded audio, its last chunk of frames ragged."""
    _, pc = chains(n_fft, hop)
    x = make_audio(seed, batch=batch, n=n)[:, 0]
    spec, _ = PK.make_fused_forward_session(pc, CHUNK)(torch.as_tensor(x))
    return spec[:, :-3]


def test_p_vs_pallas_oracle_and_generic():
    """P on the FFT route's plain version: the JAX random-decode kernel with
    the same draws, the float64 oracle, the generic scan with a generator in
    the same state."""
    n_fft, hop = 512, 128
    jc, pc = chains(n_fft, hop)
    mags = spectra(n_fft, hop).abs()
    T, F = mags.shape[1:]
    key = __import__("jax").random.PRNGKey(5)
    n_chunks = -(-T // (CHUNK // hop))
    ang = np.array(JK._session_angles(key, n_chunks, CHUNK // hop, F, 384, (2,)))[..., :F]
    y_k = PK.make_fused_random_invert(pc, CHUNK // hop, angles=torch.as_tensor(ang))(mags)
    y_j = JK.make_fused_random_invert(jc, CHUNK // hop, key=key, interpret=True)(jnp.asarray(t2n(mags)))
    assert y_k.shape == y_j.shape == (2, T * hop)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-3
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), 4.0, n_fft, hop, T, angles=ang, spec=np.float64(t2n(mags)))
    assert rel(t2n(y_k), y_o) <= 1e-5
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    y_s = PK.make_fused_random_invert(pc, CHUNK // hop, generator=g1)(mags)
    y_g = PS.scan_invert(pc, mags, CHUNK // hop, "random", generator=g2, backend="generic")
    assert rel(t2n(y_s), t2n(y_g)) <= 1e-5


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 64)])
def test_s_vs_pallas_oracle_and_generic(n_fft, hop):
    """S on the FFT route's plain version, an imaginary part at DC and
    nyquist included (unread, as the product basis does not read it)."""
    jc, pc = chains(n_fft, hop)
    spec = spectra(n_fft, hop, seed=42)
    spec[..., 0] = spec[..., 0] + 0.5j
    spec[..., -1] = spec[..., -1] - 0.25j
    T = spec.shape[1]
    y_k = PK.make_fused_complex_invert(pc, CHUNK // hop)(spec)
    if hop % 128 == 0:
        y_j = JK.make_fused_complex_invert(jc, CHUNK // hop, interpret=True)(jnp.asarray(t2n(spec)))
        assert rel(t2n(y_k), np.array(y_j)) <= 1e-4
    clean = np.complex128(t2n(spec))
    clean[..., 0] = clean[..., 0].real
    clean[..., -1] = clean[..., -1].real
    _, y_o = oracle(None, None, t2n(pc[1].inv_window), 4.0, n_fft, hop, T, spec=clean)
    assert y_k.shape == (2, T * hop) and rel(t2n(y_k), y_o) <= 1e-5
    y_g = PS.scan_invert(pc, spec, CHUNK // hop, backend="generic")
    assert rel(t2n(y_k), t2n(y_g)) <= 1e-5
    y_p = PK._synthesize(spec.real.contiguous(), spec.imag.contiguous(), pc[1].inv_window, 4.0, n_fft, hop, T)
    assert rel(t2n(y_k), t2n(y_p)) <= 1e-5          # the product route's plain version


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 64)])
def test_projection_synthesis_vs_jax_and_oracle(n_fft, hop):
    """O's projection synthesis (gain = overlap) of a grid with unwrapped
    phases and its overlap - 1 zero frames, against the JAX package's own
    projection synthesis (``pghi_gl_stream``'s irfft, overlap-add, / overlap)
    and the float64 oracle."""
    ov = n_fft // hop
    F = n_fft // 2 + 1
    rng = np.random.default_rng(7)
    Tp = 3 + 8 + ov - 1
    mag = np.abs(rng.standard_normal((2, Tp, F))).astype(np.float32)
    mag[:, -(ov - 1):] = 0.0
    ph = rng.uniform(-50.0, 50.0, (2, Tp, F)).astype(np.float32)
    _, pc = chains(n_fft, hop)
    inv_w = pc[1].inv_window
    m_t, p_t = torch.as_tensor(mag), torch.as_tensor(ph)
    y = PK._synthesis_reference(m_t * torch.cos(p_t), m_t * torch.sin(p_t), inv_w, float(ov), n_fft, hop, Tp)
    assert torch.equal(y, PK._synthesize_fft(m_t * torch.cos(p_t), m_t * torch.sin(p_t), inv_w, float(ov), n_fft,
                                             hop, Tp))
    spec = jnp.asarray(mag) * jnp.exp(1j * jnp.asarray(ph))
    y_j = np.array(j_ola(j_irfft(spec, n_fft=n_fft) * jnp.asarray(t2n(inv_w)), hop) / ov)[..., : Tp * hop]
    assert rel(t2n(y), y_j) <= 1e-5
    _, y_o = oracle(None, None, t2n(inv_w), float(ov), n_fft, hop, Tp,
                    spec=np.float64(mag) * np.exp(1j * np.float64(ph)))
    assert rel(t2n(y), y_o) <= 1e-5
    # the projection's plain version synthesizes so: its result against the
    # same projection built from this synthesis (the analysis on the FFT
    # route's schedule, frames_rfft_reference with the pairs from ctx)
    ctx, lo, hi = 3, 3 + 8 - (ov - 1), 3 + 8
    got = PK.gl_project_reference(m_t, p_t, inv_w, pc[1].window, n_fft, hop, ctx, lo, hi)
    fr = y.unfold(-1, n_fft, hop)[:, ctx:Tp - (ov - 1)]
    re, im = frames_rfft_reference(fr, pc[1].window)
    new = torch.atan2(im, re)
    rows = torch.arange(ctx, Tp - (ov - 1))
    upd = ((rows < lo) | (rows >= hi))[None, :, None]
    assert torch.equal(got[:, ctx:Tp - (ov - 1)], torch.where(upd, new, p_t[:, ctx:Tp - (ov - 1)]))


def emulate_blocks(re, im, wsyn, n_fft, hop, rows, smooth=False):
    """The decode's FFT route block by block, as ``session_decode_fft_kernel``
    computes it: a block owns the output chunks ``j0 .. j0 + rows - 1`` and
    synthesizes the frames ``j0 - (overlap - 1) ..`` (pairs (r, r + overlap)
    of its local numbering: the session's when ``rows`` is a multiple of ``2
    overlap``), adding them into its chunks in class order.  ``smooth``: the
    smooth route's instance (the mixed-radix schedule)."""
    ov = n_fft // hop
    m = ov - 1
    B, T, F = re.shape
    out = torch.zeros((B, T * hop))
    for j0 in range(0, T, rows):
        j_end = min(T, j0 + rows)
        f0 = j0 - m
        n_fr = min(rows + 2 * ov, T + m - j0)
        idx = torch.arange(f0, f0 + n_fr)
        ok = (idx >= 0)[None, :, None]
        take = idx.clamp_min(0)
        zero = torch.zeros(())
        frames = frames_irfft_reference(torch.where(ok, re[:, take], zero), torch.where(ok, im[:, take], zero),
                                        wsyn, ov, smooth)
        buf = torch.zeros((B, rows * hop))
        n_out = (j_end - j0) * hop
        for c in range(ov):                            # class (f + overlap - 1) mod overlap, in order
            for r in range(n_fr):
                f = f0 + r
                if f < 0 or (f + m) % ov != c:
                    continue
                p0 = (f - j0) * hop
                lo, hi = max(0, -p0), min(n_fft, n_out - p0)
                if hi > lo:
                    buf[:, p0 + lo: p0 + hi] = buf[:, p0 + lo: p0 + hi] + frames[:, r, lo:hi]
        out[:, j0 * hop: j_end * hop] = buf[:, :n_out]
    return out


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (128, 64)])
def test_blocks_keep_the_session_wide_pairing(n_fft, hop):
    """Block by block, at every height the plans could pick (multiples of 2
    overlap: P and S's, O's narrow one), the FFT schedule gives the whole
    session's plain version bit for bit; blocks of overlap chunks would pair
    other frames and not round alike."""
    ov = n_fft // hop
    F = n_fft // 2 + 1
    rng = np.random.default_rng(11)
    T = 6 * ov + 3
    mag = torch.as_tensor(np.abs(rng.standard_normal((2, T, F))).astype(np.float32))
    ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, (2, T, F)).astype(np.float32))
    inv_w = torch.hann_window(n_fft)
    whole = PK.session_decode_reference(mag, ang, inv_w, 2.0, n_fft, hop)
    re, im = mag * torch.cos(ang), mag * torch.sin(ang)
    wsyn = irfft_window(inv_w / 2.0, n_fft)
    for rows in (2 * ov, 4 * ov):
        assert torch.equal(emulate_blocks(re, im, wsyn, n_fft, hop, rows), whole)
    odd = emulate_blocks(re, im, wsyn, n_fft, hop, ov)
    assert not torch.equal(odd, whole) and rel(t2n(odd), t2n(whole)) <= 1e-5


def test_plans_routes_and_no_launch_on_the_cpu():
    """The FFT route's blocks: P and S's rows a multiple of 2 overlap with two
    blocks an SM where they fit (56 chunks, 4 FFTs at 1024/256); O's narrow
    blocks the smallest multiple of 2 overlap that holds 8 chunks; the
    product route at n_fft neither FFT route takes (1408/352; 1344/336 takes
    the smooth route's radix-7 instance) keeps its height.  On the CPU every
    session runs its plain version and nothing is counted."""
    assert PK._decode_plan(1024, 256) == (56, 4)
    assert PK._decode_plan(1024, 256, PK.PROJECT_SYN_ROWS) == (8, 4)
    assert PK._decode_plan(4096, 512, PK.PROJECT_SYN_ROWS)[0] == 16
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        for ov in (2, 4, 8):
            hop = n_fft // ov
            for narrow in (None, PK.PROJECT_SYN_ROWS):
                rows, teams = PK._decode_plan(n_fft, hop, narrow)
                assert rows % (2 * ov) == 0 and teams >= 1
                assert PK._decode_fft_smem_bytes(rows, hop, n_fft, teams) <= MAX_SMEM
            rows, teams = PK._decode_plan(n_fft, hop)
            assert PK._decode_fft_smem_bytes(rows, hop, n_fft, teams) <= TWO_BLOCKS_SMEM
            assert PK.kernel_covers("decode", n_fft, hop)
    assert not fft_covers(1408) and PK._decode_plan(1408, 352) == (PK._pick_rows("decode", 1408, 352), 0)
    assert PK._decode_plan(1408, 352, 8) == (8, 0)
    assert not fft_covers(1344) and PK._decode_plan(1344, 336)[1] > 0 and PK._decode_plan(1344, 336, 8)[1] > 0
    syn, wsyn, tw = PK._decode_operands(torch.hann_window(512), 4.0, 512, 128)
    assert syn is None and wsyn.shape == (512,) and tw.shape == (2, 512)
    syn, wsyn, tw = PK._decode_operands(torch.hann_window(1408), 4.0, 1408, 352)
    assert syn.shape[0] == 4 and wsyn is None and tw is None
    syn, wsyn, tw = PK._decode_operands(torch.hann_window(1344), 4.0, 1344, 336)
    assert syn is None and wsyn.shape == (1344,) and tw.shape == (2, 1344)
    _, pc = chains(256, 64)
    PK.reset_launches()
    mags = torch.rand(2, 20, 129)
    PS.scan_invert(pc, mags, 8, "random", generator=torch.Generator().manual_seed(0), backend="fused")
    PS.scan_invert(pc, torch.polar(mags, mags), 8, backend="fused")
    assert not any(PK.launches.values()) and not any(PK.routes.values())
    assert {f"{k}:{r}" for k in ("session_random_decode", "session_complex_decode", "gl_project_synthesis")
            for r in ("fft", "smooth", "product")} <= set(PK.routes)
