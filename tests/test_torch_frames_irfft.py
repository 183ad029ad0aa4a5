"""The inverse shared-memory FFT (``csrc/fft_smem.cuh:frames_irfft``) and the
FFT route of the full-K Griffin-Lim step (J) and the streaming roundtrips (L,
M), as their plain versions (``ops/cuda/frames_fft.py``, ``glstep.py``,
``stream_step.py``), which repeat the kernels' schedules:

* ``frames_irfft_reference`` against a float64 ``np.fft.irfft`` oracle at
  every size the route takes, under hann and the DGT's gaussian, with
  imaginary parts at DC and nyquist that the inverse must drop, for pair
  strides 1 to 8: within 1e-6 of the largest sample (float32 sums over 2.5 n
  log2 n terms: 1-2e-7 measured);
* the analysis, synthesis and class-ordered overlap-add of the FFT route
  against the product plain versions (window-folded DFT matrices, one
  overlap-add), within 1e-5 of the largest sample (both float32);
* ``frames_rfft_reference`` with its default stride bit for bit as it was
  before it took a stride (a frozen copy below);
* J at 1024/256 and L / M under the DGT's window at 1024/256 against the JAX
  package's Pallas kernels in interpret mode (J on the frames inside the
  trimmed signal, 1e-4 of the projection's largest value; L 1e-4, M 1e-3: the
  TPU products are bf16x3/x4) and against float64 oracles (2e-6 for J, 1e-5
  for L and M); L / M on the product route at 1408/352 (1200/300 takes the
  smooth route since it exists, 1344/336 its radix-7 stage) against the oracle;
* the route rule (``n_fft`` alone), the coverage of every shape the gates took
  before the FFT route, and ``pghi_gl`` on the FFT schedule converging like
  the eager loop.

On the card ``chip_smoke.py`` holds the kernels against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.pallas import glstep as JG
from acids_transforms_tpu.ops.pallas import stream_step as JK
from acids_transforms_tpu.ops.windows import gaussian_dgt_window as jgauss
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.ops import griffinlim as pgl
from acids_transforms_tpu_torch.ops.cuda import glstep as PG
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.cuda.frames_fft import (
    _stockham,
    fft_covers,
    fft_covers_smooth,
    fft_covers_smooth7,
    fft_smooth_max_teams,
    fft_twiddles,
    frames_irfft_reference,
    frames_rfft_reference,
    irfft_window,
    overlap_add_classes,
)
from acids_transforms_tpu_torch.ops.fft import _dft_matrices, _idft_matrices, _tables, istft, stft
from acids_transforms_tpu_torch.ops.framing import frame, overlap_add
from acids_transforms_tpu_torch.ops.windows import gaussian_dgt_window, get_window
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_kernel import oracle as session_oracle

SIZES = [64, 128, 256, 512, 1024, 2048, 4096]


def window(name, n):
    return gaussian_dgt_window(n) if name == "gaussian" else get_window("hann", n)


@pytest.mark.parametrize("wname", ["hann", "gaussian"])
@pytest.mark.parametrize("n", SIZES)
def test_irfft_reference_vs_float64_oracle(n, wname):
    rng = np.random.default_rng(n + 7)
    F = n // 2 + 1
    re = rng.standard_normal((2, 7, F)).astype(np.float32)        # 7 frames: a partner is missing
    im = rng.standard_normal((2, 7, F)).astype(np.float32)        # non-zero at DC and nyquist too
    re[1, 3] *= 1e-3                                              # a quiet frame beside loud ones
    w = window(wname, n)
    want = np.fft.irfft(np.float64(re) + 1j * np.float64(im), n=n, axis=-1) * np.float64(t2n(w))
    for stride in (1, 2, 4, 8):
        got = frames_irfft_reference(torch.as_tensor(re), torch.as_tensor(im), irfft_window(w, n), stride)
        assert got.shape == (2, 7, n) and got.dtype == torch.float32
        assert rel(t2n(got), want) <= 1e-6, stride
    # the imaginary parts at DC and nyquist are not read
    im2 = im.copy()
    im2[..., 0] = 5.0
    im2[..., -1] = -3.0
    a = frames_irfft_reference(torch.as_tensor(re), torch.as_tensor(im), irfft_window(w, n), 4)
    b = frames_irfft_reference(torch.as_tensor(re), torch.as_tensor(im2), irfft_window(w, n), 4)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,hop", [(256, 64), (1024, 256), (2048, 256), (4096, 2048)])
def test_fft_roundtrip_vs_product_plain_versions(n, hop):
    """Analysis with pair stride ``n / hop``, synthesis, overlap-add in class
    order: the FFT route's schedule against the window-folded products."""
    ov = n // hop
    x = torch.as_tensor(make_audio(n, batch=2, n=13 * hop + n)[:, 0])
    frames = frame(x, n, hop)                                     # 14 frames
    w = get_window("hann", n)
    ws = gaussian_dgt_window(n)
    re, im = frames_rfft_reference(frames, w, ov)
    y = overlap_add_classes(frames_irfft_reference(re, im, irfft_window(ws, n), ov), hop, 3)
    C, S = (torch.as_tensor(m) for m in _dft_matrices(n))
    A, B = (torch.as_tensor(m) for m in _idft_matrices(n))
    pre, pim = torch.matmul(frames * w, C), torch.matmul(frames * w, S)
    want = overlap_add((torch.matmul(pre, A) + torch.matmul(pim, B)) * ws, hop)
    assert y.shape == want.shape and rel(t2n(y), t2n(want)) <= 1e-5
    assert rel(t2n(re), t2n(pre)) <= 1e-5 and rel(t2n(im), t2n(pim)) <= 1e-5
    # the class order only reorders each sample's terms
    fr = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 9, n)).astype(np.float32))
    assert rel(t2n(overlap_add_classes(fr, hop, 1)), t2n(overlap_add(fr, hop))) <= 1e-6


def _rfft_reference_before_the_stride(frames, window):
    """``frames_rfft_reference`` as it was before it took a pair stride."""
    n = frames.shape[-1]
    lead, T = frames.shape[:-2], frames.shape[-2]
    x = frames.reshape((-1, T, n)).to(torch.float32)
    if T % 2:
        x = torch.cat([x, x.new_zeros((x.shape[0], 1, n))], dim=1)
    w = window.to(device=x.device, dtype=torch.float32)
    pairs = x.reshape(x.shape[0], -1, 2, n)
    re = (w * pairs[:, :, 0]).reshape(-1, n)
    im = (w * pairs[:, :, 1]).reshape(-1, n)
    (tw,) = _tables(fft_twiddles, x.device, n)
    zr, zi = _stockham(re, im, tw[0], tw[1])
    F = n // 2 + 1
    k = torch.arange(F, device=x.device)
    a, b = zr[:, :F], zi[:, :F]
    c, d = zr[:, (n - k) % n], zi[:, (n - k) % n]
    x0r, x0i = (a + c) * 0.5, (b - d) * 0.5
    x1r, x1i = (b + d) * 0.5, (c - a) * 0.5
    re = torch.stack([x0r, x1r], dim=1).reshape(x.shape[0], -1, F)[:, :T]
    im = torch.stack([x0i, x1i], dim=1).reshape(x.shape[0], -1, F)[:, :T]
    return re.reshape(lead + (T, F)), im.reshape(lead + (T, F))


@pytest.mark.parametrize("n", SIZES)
def test_rfft_reference_default_stride_is_unchanged(n):
    rng = np.random.default_rng(n + 3)
    for shape in ((2, 5, n), (3, 1, 4, n), (1, n)):
        fr = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        w = window("gaussian", n)
        got = frames_rfft_reference(fr, w)
        want = _rfft_reference_before_the_stride(fr, w)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), shape


# ---------------------------------------------------------------- J, L, M
MOM = 0.99 / 1.99


def test_j_fft_schedule_vs_pallas_kernel_and_oracle():
    n, hop = 1024, 256
    rng = np.random.default_rng(61)
    w = np.array(jgauss(n))
    x = make_audio(61, batch=2, n=9000)[:, 0]
    mag = np.abs(np.asarray(jfft.stft(jnp.asarray(x), n, hop, jnp.asarray(w)))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    st = (np.cos(ph), np.sin(ph), (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32),
          (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32))
    step, to_rows, from_rows = JG.make_gl_momentum_step_fullk(jnp.asarray(mag), n, hop, jnp.asarray(w), MOM,
                                                               interpret=True)
    jo = [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]
    pstep, _, _ = PG.make_gl_momentum_step_fullk(torch.as_tensor(mag), n, hop, torch.as_tensor(w), MOM)
    po = [t2n(o) for o in pstep(*[torch.as_tensor(a) for a in st])]
    env = PG._env_rows(mag.shape[1], n, hop, torch.as_tensor(w))
    oo = [o.numpy() for o in PG.gl_momentum_step_fullk_oracle(
        torch.as_tensor(mag), *[torch.as_tensor(a) for a in st], env, n, hop, torch.as_tensor(w), MOM)]

    def proj_err(got, ref, sl=slice(None)):
        scale = max(np.abs(ref[2]).max(), np.abs(ref[3]).max())
        return max(np.abs(got[i][:, sl] - ref[i][:, sl]).max() for i in (2, 3)) / scale

    inner = slice((n // 2) // hop, mag.shape[1] - (n // 2) // hop)
    assert proj_err(po, jo, inner) <= 1e-4
    assert proj_err(po, oo) <= 2e-6
    spec = torch.complex(torch.as_tensor(mag * st[0]), torch.as_tensor(mag * st[1]))
    wt = torch.as_tensor(w)
    reb = stft(istft(spec, n, hop, wt), n, hop, wt)
    assert proj_err(po, [None, None, t2n(reb.real), t2n(reb.imag)]) <= 2e-6
    assert np.abs(np.sqrt(po[0] ** 2 + po[1] ** 2) - 1.0).max() <= 1e-5


def test_l_and_m_fft_schedule_under_the_dgt_window_vs_pallas_and_oracle():
    n, hop, chunk = 1024, 256, 2048
    x = make_audio(63, batch=2, n=3 * chunk + 300)[:, 0]             # 4 chunks, ragged tail
    jc = JT.OverlapAdd(n, hop) + JT.RealtimeDGT(n_fft=n, hop_length=hop)
    pc = PT.OverlapAdd(n, hop, device="cpu") + PT.RealtimeDGT(n_fft=n, hop_length=hop, device="cpu")
    T = 4 * chunk // hop
    y_k = PK.make_fused_roundtrip(pc, chunk)(torch.as_tensor(x))
    y_j = JK.make_fused_roundtrip(jc, chunk, interpret=True)(jnp.asarray(x))
    assert y_k.shape == y_j.shape == (2, T * hop)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-4
    gain = float(pc[0].gain_compensation)
    _, y_o = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), gain, n, hop, T)
    assert rel(t2n(y_k), y_o) <= 1e-5
    key = jax.random.PRNGKey(17)
    F = n // 2 + 1
    ang = np.array(JK._session_angles(key, 4, chunk // hop, F, 640, (2,)))[..., :F]
    y_k = PK.make_fused_random_roundtrip(pc, chunk, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    y_j = JK.make_fused_random_roundtrip(jc, chunk, key=key, interpret=True)(jnp.asarray(x))
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-3
    _, y_o = session_oracle(x, t2n(pc[1].window), t2n(pc[1].inv_window), gain, n, hop, T, angles=ang)
    assert rel(t2n(y_k), y_o) <= 1e-5


@pytest.mark.parametrize("random", [False, True])
def test_l_and_m_product_route_vs_oracle(random):
    n, hop, chunk = 1408, 352, 2816                    # 2^7 11: neither the FFT nor the smooth route
    assert not fft_covers(n) and not fft_covers_smooth(n) and not fft_covers_smooth7(n)
    assert PK.session_route(n, "roundtrip", hop) == "product"
    # 1344/336 (2^6 3 7), this test's shape before: the smooth route's radix-7 stage
    assert PK.session_route(1344, "roundtrip", 336) == "smooth"
    x = make_audio(65, batch=2, n=2 * chunk + 100)[:, 0]
    rt = PT.RealtimeSTFT(n_fft=n, hop_length=hop, device="cpu")
    T = 3 * chunk // hop
    ang = np.random.default_rng(5).uniform(-np.pi, np.pi, (2, T, n // 2 + 1)).astype(np.float32) if random else None
    y = PK.session_roundtrip_reference(torch.as_tensor(x), rt.window, rt.inv_window, 4.0, n, hop, T,
                                       None if ang is None else torch.as_tensor(ang))
    _, y_o = session_oracle(x, t2n(rt.window), t2n(rt.inv_window), 4.0, n, hop, T, angles=ang)
    assert rel(t2n(y), y_o) <= 1e-5


def test_route_rule():
    """``n_fft`` alone picks the route of L and M, ``(n_fft, hop)`` J's (the
    smooth route where its block fits: at every even 5-smooth shape J takes)."""
    assert PG._fullk_plan(1024, 256) == ("fft", 60, 56, 4)
    assert PG._fullk_plan(4096, 512)[0] == "fft" and PG._fullk_plan(2048, 256)[0] == "fft"
    assert PG._fullk_plan(768, 256)[0] == "smooth" and PG._fullk_plan(8192, 2048)[0] == "product"
    assert PG._fullk_plan(896, 224)[0] == "smooth"                 # 2^7 7: the smooth route's radix-7 instance
    assert PG._fullk_plan(1408, 352)[0] == "product"               # 2^7 11: neither the FFT nor the smooth route
    assert PG._fullk_plan(8192, 2048)[3] == 1056                   # slabs of 1056 columns
    assert PK._roundtrip_plan(1024, 256) == (24, 4)
    # 1200 and 960 (5-smooth) take the smooth route; 1408 = 2^7 11 the product;
    # 1344 = 2^6 3 7 the smooth route's radix-7 stage
    assert PK._roundtrip_plan(1200, 300) == (16, 2) and PK.session_route(1200, "roundtrip", 300) == "smooth"
    assert PK._roundtrip_plan(960, 240)[1] > 0 and PK.session_route(960, "roundtrip", 240) == "smooth"
    assert PK._roundtrip_plan(1408, 352) == (PK._pick_rows("roundtrip", 1408, 352), 0)
    assert PK._roundtrip_plan(1344, 336)[1] > 0 and PK.session_route(1344, "roundtrip", 336) == "smooth"
    for n, hop in ((512, 128), (2048, 512), (4096, 1024), (128, 32)):
        assert PK._roundtrip_plan(n, hop)[1] > 0 and PG._fullk_plan(n, hop)[0] == "fft"
    assert PK._roundtrip_plan(64, 16)[1] > 0


def _shapes():
    out = []
    for n in [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 768, 960, 1200, 1536, 3072]:
        for ov in range(2, 9):
            if n % ov == 0:
                out.append((n, n // ov))
    return out


def test_no_shape_covered_before_now_raises():
    """Every shape the full-K step and the roundtrip sessions took before the
    FFT and smooth routes (the product's plans, which the code still
    computes) keeps a block, short clips included, and the FFT and smooth
    routes' blocks keep their kernels' conditions."""
    for n, hop in _shapes():
        ov = n // hop
        if PG.gl_fullk_available(n, hop) and PG._pick_fullk_block(n, hop) is not None:
            old = PG._pick_fullk_block(n, hop)
            plan = PG._fullk_plan(n, hop)
            assert plan is not None and (plan[0] == "fft") == fft_covers(n), (n, hop)
            assert (plan[0] == "smooth") == fft_covers_smooth(n), (n, hop)
            for T in range(2, 13):
                if PG._fullk_reflection_covered(T, n, hop, old[0], old[1]):
                    assert PG._fullk_reflection_covered(T, n, hop, plan[1], plan[2]), (n, hop, T)
            if plan[0] != "product":
                route, rows, tile_t, teams = plan
                most = 4096 // n if fft_covers(n) else fft_smooth_max_teams(n)
                assert tile_t % (2 * ov) == 0 and rows == tile_t + ov and 1 <= teams <= most
                assert PG._fullk_fft_smem_bytes(rows, hop, n, teams) <= PG.MAX_SMEM
        if PK.kernel_covers("roundtrip", n, hop):
            rows, teams = PK._roundtrip_plan(n, hop)
            assert (teams > 0) == (fft_covers(n) or fft_covers_smooth(n)), (n, hop)
            if teams:
                most = 4096 // n if fft_covers(n) else fft_smooth_max_teams(n)
                assert rows % (2 * ov) == 0 and 1 <= teams <= most
                assert PK._roundtrip_fft_smem_bytes(rows, ov, hop, teams) <= PK.MAX_SMEM
            else:
                assert rows == PK._pick_rows("roundtrip", n, hop)


def test_pghi_gl_on_the_fft_schedule_converges_like_the_eager_loop():
    """D' at a small size: the DGT's PGHI seed polished by the full-K step's
    plain version (the FFT schedule) ends within the spectral-convergence
    margin of the eager loop's (``tests/test_gl_parity.py``'s
    ``max(1.15 s, s + 0.02)``)."""
    n, hop = 512, 128
    dgt = PT.DGT(n_fft=n, hop_length=hop, device="cpu")
    dgt.gl_iterations = 8
    x = torch.as_tensor(make_audio(67, batch=2, n=20000)[:, 0])
    m = dgt(x).abs()
    ph = dgt.pghi(m, angles=torch.zeros_like(m))

    def sc(y):
        R = dgt(y).abs()[..., : m.shape[-2], :]
        return (torch.linalg.norm(R - m) / torch.linalg.norm(m)).item()

    PG.reset_launches()
    s_k = sc(dgt.griffin_lim(m, init_phase=ph, fused=True))
    s_e = sc(dgt.griffin_lim(m, init_phase=ph, fused=False))
    assert s_k < max(1.15 * s_e, s_e + 0.02)
    assert s_k < sc(dgt.invert(torch.polar(m, ph)))               # the polish improves on the seed
    assert not any(PG.routes.values()) and set(PG.routes) == {
        k + ":" + r for k in ("gl_momentum_fullk", "gl_momentum_step", "gl_momentum_chain", "gl_project")
        for r in ("fft", "smooth", "product")}
