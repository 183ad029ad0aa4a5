"""O's two-launch projection analysis on the FFT and smooth routes, and O's
polish on its radix-7 instance: ``csrc/stream_step.cu:
gl_project_analysis_fft_kernel<kSmooth, kSeven>`` (the encode's FFT-route
block on the grid's signal, ``frames_rfft`` with the polish's pairs, plan
``stream_step._encode_plan``) wherever ``frames_fft.fft_covers(n_fft)`` or
``fft_covers_smooth7(n_fft)``, ``gl_project_analysis_kernel`` (the product)
elsewhere; ``gl_polish_fft_kernel<., true, true>`` wherever n_fft has a factor
7 and ``stream_step._polish_plan`` holds the grid.  The route reads n_fft
alone (``stream_step.session_route(n_fft, "project" / "polish")``).  The
plain versions (``gl_project_analysis_reference``, ``gl_project_reference``,
``gl_polish_reference``, which is ``iters`` calls of the projection's) are
what ``chip_smoke.py`` holds the kernels to on the card.

Tolerances, and why:

* the plain polish on the radix-7 instance (1344/336) and the plain
  projection on the FFT route (4096/1024) against the JAX package's
  projections (``RealtimeSTFT.pghi_gl_stream``'s, written from its
  operations), once and ``iters`` times: ``|X| (cos, sin)(phase)`` within
  1e-4 of the largest ``|X|``, as ``test_torch_pghi_polish_smooth.py`` holds
  the smooth route; the pinned, frozen and zero rows bit for bit;
* the plain analysis on the smooth route (3072/768, 3584/896) against a
  float64 oracle (numpy's rfft of the float32 signal's frames under the
  window, in float64): ``|Y| (cos, sin)(phase)`` within 1e-5 of the largest
  ``|Y|`` (a bin's angle is only as good as its magnitude), and no further
  from it than the product analysis on the same input;
* ``iters`` plain two-launch projections against the plain polish: bit for
  bit (the same function in the same schedule);
* the CPU sessions against the port's generic scan with a generator in the
  same state: spectral convergence within ``1.1 s + 1e-3`` of the scan's
  (``bench.py:582, 664``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.cuda.frames_fft import (
    MAX_SMEM,
    fft_covers,
    fft_covers_smooth,
    fft_covers_smooth7,
)
from test_torch_common import make_audio, t2n
from test_torch_gl_polish_fft import ITERS, T_C, grid, jax_project, rt_pair, unit_err
from test_torch_streaming import spectral_convergence

torch.set_num_threads(1)

# the even 5-smooth pghi_gl shapes with hop >= 1200 that the card refused at
# 24-40 polished frames while the analysis was a product of one block
FORMER_REFUSALS = ((2560, 1280), (2592, 1296), (2880, 1440), (3000, 1500), (3072, 1536), (3200, 1600),
                   (3240, 1620), (3456, 1728), (3600, 1200), (3600, 1800), (3840, 1280), (3840, 1920),
                   (3888, 1296), (3888, 1944), (4000, 2000))


def session_shapes():
    """Every ``(n_fft, hop)`` the session kernels' layout takes: n_fft even
    from 64 to 4096, overlap 2 to 8, hop a multiple of 4."""
    for n in range(64, 4097, 2):
        for ov in range(2, 9):
            if n % ov == 0 and (n // ov) % 4 == 0:
                yield n, n // ov


# ------------------------------------------------------------------ rules
def test_route_rule_reads_n_fft_alone():
    """The analysis's route is fft / smooth / product by n_fft alone, the
    decode's; the polish's is the same, so ``"smooth"`` at every even
    7-smooth n_fft with a factor 7; ``_polish_plan`` holds 1344/336's and
    896/224's grids of 3 + 8 + 3 frames (two and four FFTs side by side)."""
    n_seven = 0
    for n in range(64, 4097, 2):
        want = "fft" if fft_covers(n) else "smooth" if fft_covers_smooth7(n) else "product"
        assert PK.session_route(n, "project") == PK.session_route(n, "decode") == want, n
        assert PK.session_route(n, "polish") == want, n
        if fft_covers_smooth7(n) and not fft_covers_smooth(n):
            n_seven += 1
            assert n % 7 == 0 and PK.session_route(n, "polish") == "smooth"
    assert n_seven == 76
    assert PK._polish_plan(1344, 336, 3 + 8 + 3) == (2, True)
    assert PK._polish_plan(896, 224, 3 + 8 + 3) == (4, True)
    # 3584/896 with 40-frame chunks: no polish block holds the grid
    assert PK._polish_plan(3584, 896, 3 + 40 + 3) is None and PK._polish_plan(3584, 896, 3 + 8 + 3) is not None
    assert PK.session_route(1408, "project") == PK.session_route(1408, "polish") == "product"


def test_coverage_and_plans():
    """``kernel_covers("project", ...)`` at the 15 formerly refused shapes;
    the product route's 40-frame limit at 1408/352 (41 frames refused, with
    the K10-K17 message); every analysis plan an even frame count within
    shared memory; no shape the two-launch route covered before stops being
    covered."""
    for n, hop in FORMER_REFUSALS:
        assert PK.kernel_covers("decode", n, hop) and PK.session_route(n, "project") == "smooth"
        for rows in (24, 39, 40, 41, 64):
            assert PK.kernel_covers("project", n, hop, rows, 3), (n, hop, rows)
    assert PK.kernel_covers("project", 1408, 352, 40, 3) and not PK.kernel_covers("project", 1408, 352, 41, 3)
    with pytest.raises(NotImplementedError, match="K10-K17"):
        PK._require("project", 1408, 352, 41, 3)
    assert PK._encode_plan(4096, 1024) == (8, 1)     # 5 blocks a session at 40 frames
    n_plans = 0
    for n, hop in session_shapes():
        if PK.session_route(n, "project") != "product" and PK.kernel_covers("decode", n, hop):
            rows, teams = PK._encode_plan(n, hop)
            assert rows >= 2 and rows % 2 == 0 and teams >= 1, (n, hop)
            assert PK._encode_fft_smem_bytes(rows, hop, n, teams) <= MAX_SMEM
            n_plans += 1
        for rows in (8, 24, 40):
            # the rule before: P's limits and at most 40 frames whose samples fit one block
            before = (PK.kernel_covers("decode", n, hop)
                      and PK._encode_smem_bytes(rows, hop, PK._k_analysis(n)) <= MAX_SMEM)
            if before:
                assert PK.kernel_covers("project", n, hop, rows, 3), (n, hop, rows)
    assert n_plans == 483


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("n_fft,hop,polish", [(1344, 336, True), (4096, 1024, False)])
def test_plain_versions_vs_jax_projections(n_fft, hop, polish):
    """The radix-7 plain polish at 1344/336 and the FFT-route plain two-launch
    projection at 4096/1024 against the JAX package's projection, once and
    ``iters`` times, on 2 sessions; the pinned, frozen and zero rows keep
    their bits."""
    jrt, prt = rt_pair(n_fft, hop, 0)
    mag, ph, Tx = grid(n_fft, hop, 0, 2, seed=3 * n_fft)
    ctx = prt.gl_context
    lo, hi = prt.gl_frozen(T_C)
    m, p = torch.as_tensor(mag), torch.as_tensor(ph)
    args = (prt.inv_window, prt.window, n_fft, hop, ctx, lo, hi)
    ref, got = jnp.asarray(ph[:, :Tx]), p.clone()
    for iters in range(1, ITERS + 1):
        ref = jax_project(jrt, jnp.asarray(mag[:, :Tx]), ref, T_C, n_fft, hop)
        if not polish:
            got = PK.gl_project_reference(m, got, *args)
        if iters in (1, ITERS):
            out = PK.gl_polish_reference(m, p, *args, iters) if polish else got
            assert unit_err(mag[:, :Tx], t2n(out)[:, :Tx], np.array(ref)) <= 1e-4, iters
    g = t2n(out)
    assert np.array_equal(g[:, :ctx], ph[:, :ctx]) and np.array_equal(g[:, lo:hi], ph[:, lo:hi])
    assert np.array_equal(g[:, Tx:], ph[:, Tx:]) and not np.array_equal(g[:, ctx:lo], ph[:, ctx:lo])


# ---------------------------------------------------- float64 oracle
@pytest.mark.parametrize("n_fft,hop", [(3072, 768), (3584, 896)])
def test_plain_analysis_vs_float64_oracle(n_fft, hop):
    """The plain analysis on the smooth route (3584 = 2^9 7: its radix-7
    schedule) of a random signal within 1e-5 of the float64 analysis, read as
    ``|Y| (cos, sin)``, and no further from it than the product analysis;
    the pinned and frozen rows untouched."""
    ov, F, ctx = n_fft // hop, n_fft // 2 + 1, 3
    Tx = ctx + T_C
    Tp = Tx + ov - 1
    rng = np.random.default_rng(n_fft)
    y = rng.standard_normal((2, Tp * hop)).astype(np.float32)
    ph = rng.uniform(-30.0, 30.0, (2, Tp, F)).astype(np.float32)
    _, prt = rt_pair(n_fft, hop, 0)
    lo, hi = prt.gl_frozen(T_C)
    win = prt.window
    assert PK.session_route(n_fft, "project") == "smooth"
    got = t2n(PK.gl_project_analysis_reference(torch.as_tensor(y), torch.as_tensor(ph), win, n_fft, hop, ctx,
                                               lo, hi))
    fr = np.stack([y[:, f * hop: f * hop + n_fft] for f in range(ctx, Tx)], axis=1).astype(np.float64)
    Y = np.fft.rfft(fr * np.float64(t2n(win)), axis=-1)
    WC, WS = PK._ana_basis(win, n_fft)
    frt = torch.as_tensor(fr.astype(np.float32))
    prod = t2n(torch.atan2(torch.matmul(frt, WS), torch.matmul(frt, WC)))
    upd = np.ones(Tx - ctx, dtype=bool)
    upd[lo - ctx: hi - ctx] = False
    mag = np.abs(Y)[:, upd]

    def off(a):
        a, b = np.float64(a)[:, upd], np.angle(Y)[:, upd]
        return float(np.abs(mag * np.stack([np.cos(a) - np.cos(b), np.sin(a) - np.sin(b)])).max() / mag.max())
    e_fft, e_prod = off(got[:, ctx:Tx]), off(prod)
    assert e_fft <= 1e-5 and e_fft <= e_prod, (e_fft, e_prod)
    assert np.array_equal(got[:, :ctx], ph[:, :ctx]) and np.array_equal(got[:, lo:hi], ph[:, lo:hi])
    assert np.array_equal(got[:, Tx:], ph[:, Tx:])


# ------------------------------------------------ the two halves agree
@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (1200, 300), (1344, 336)])
def test_two_launch_projections_equal_the_polish(n_fft, hop):
    """``iters`` plain two-launch projections (``gl_project_reference``:
    the decode's synthesis, then the analysis on its route) equal
    ``gl_polish_reference`` bit for bit; the CPU wrapper runs it."""
    _, prt = rt_pair(n_fft, hop, 0)
    mag, ph, _ = grid(n_fft, hop, 0, 2, seed=n_fft + 11)
    m, p = torch.as_tensor(mag), torch.as_tensor(ph)
    lo, hi = prt.gl_frozen(T_C)
    args = (n_fft, hop, prt.gl_context, lo, hi)
    assert PK._polish_plan(n_fft, hop, m.shape[1]) is not None
    pol = PK.gl_polish_reference(m, p, prt.inv_window, prt.window, *args, ITERS)
    two = p.clone()
    for _ in range(ITERS):
        two = PK.gl_project_reference(m, two, prt.inv_window, prt.window, *args)
    assert torch.equal(two, pol)
    assert torch.equal(PK.gl_polish(m, p.clone(), None, prt.inv_window, prt.window, None, None, *args, ITERS), pol)


# -------------------------------------------------------- whole sessions
@pytest.mark.parametrize("n_fft,hop,t_c", [(1344, 336, T_C), (2560, 1280, 39)])
def test_session_vs_generic_scan(n_fft, hop, t_c):
    """A ``pghi_gl`` roundtrip through the port's CPU session (the polish's
    radix-7 plain version at 1344/336; at 2560/1280 with 39-frame chunks,
    which no polish block holds, the two-launch projection's smooth plain
    version) against the generic scan with a generator in the same state; no
    launch is counted on the CPU."""
    chunk = t_c * hop
    chain = PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(
        n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl", gl_iterations=ITERS, device="cpu")
    tp = chain[1].gl_context + t_c + n_fft // hop - 1
    assert (PK._polish_plan(n_fft, hop, tp) is None) == (n_fft == 2560)
    assert PK.fused_pghi_gl_roundtrip_available(chain, chunk)
    x = make_audio(41, batch=2, n=2 * chunk + 300)[:, 0]
    xt = torch.as_tensor(x)
    d = n_fft - hop
    PK.reset_launches()
    a = t2n(PS.scan_roundtrip(chain, xt, chunk, "pghi_gl", generator=torch.Generator().manual_seed(5),
                              backend="fused"))
    b = t2n(PS.scan_roundtrip(chain, xt, chunk, "pghi_gl", generator=torch.Generator().manual_seed(5),
                              backend="generic"))
    assert a.shape == b.shape and np.isfinite(a).all()
    s_a = spectral_convergence(a[:, d:], x, n_fft, hop)
    s_b = spectral_convergence(b[:, d:], x, n_fft, hop)
    assert s_a <= 1.1 * s_b + 1e-3 and s_a < 0.5, (s_a, s_b)
    assert not any(PK.launches.values()) and not any(PK.routes.values())
    assert {"gl_project_analysis:fft", "gl_project_analysis:smooth", "gl_project_analysis:product"} <= set(PK.routes)
