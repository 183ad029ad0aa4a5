"""The Griffin-Lim steps C, D and I on the smooth route's radix-7 instance:
where ``frames_fft.fft_covers_smooth7(n_fft)`` and ``n_fft`` has a factor 7
(even, ``2^a 3^b 5^c 7^d``: 896, 1344, 1568, 672, ...) and a block fits, C
(one step), D (a chain in one cooperative launch) and I (the projection
alone) run ``csrc/glstep.cu:gl_step_fft_kernel<true, true>``
(``frames_irfft<true, true>`` / ``frames_rfft<true, true>``, a radix-7 stage
first), whose plain version is ``glstep._project_fft(..., smooth=True)`` and
the update as the kernel rounds it.  1408 = 2^7 11 keeps the product route.
C, D, I and J share one coverage question (``glstep._fft_plan``).
``chip_smoke.py`` holds the kernel to this plain version on the card.

Tolerances, and why:

* against the JAX package's Pallas kernels in interpret mode at 896/224, as
  ``test_torch_glstep_smooth.py`` holds the 5-smooth instance: C and I
  within 1e-4 of the largest projection value, D (a chain of 4 of a chaotic
  map, fed the JAX side's bf16x3 rounding) within 1e-3; on the interior
  frames under hann (its edge frames are the JAX kernel's rounding over w ~
  4e-5), on every frame under hamming (w >= 0.08); the angles real at
  nyquist: 896 % 256 != 0, so the JAX kernel leaks the nyquist bin's
  imaginary part into bin N - 1 (ROADMAP Queue 3), which the port drops;
* against the float64 oracle (``gl_momentum_step_oracle``) within 1e-5 of
  the largest value on every frame, at 896/224, 1568/224 (radices 7 7) and
  672/96 (overlap 7), and no further from it than the product route's
  plain version at the same shape (that route reached by sending the rule
  to the product, as ``test_torch_glstep_smooth.py`` does);
* the eager loop's spectral convergence: within ``max(1.15 s, s + 0.02)``
  (``tests/test_gl_parity.py``'s margin).
"""
import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu.ops.pallas import glstep as JG
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import glstep as PG
from test_torch_common import make_audio, t2n
from test_torch_glstep_smooth import (MOM, on_product, projection_err, real_at_nyquist, run_jax, run_port,
                                      step_case, tensors)

torch.set_num_threads(1)

#: even 7-smooth sizes with a factor 7, 64 to 4096
SEVEN_SIZES = [n for n in range(64, FF.FFT_MAX + 1, 2) if FF.fft_covers_smooth7(n) and n % 7 == 0]
#: radix 7 at overlap 4, radices 7 7 at overlap 7, 2^5 3 7 at overlap 7
ORACLE_SHAPES = [(896, 224), (1568, 224), (672, 96)]


def gate_shapes(sizes):
    """Every shape of ``sizes`` the Griffin-Lim gate takes (hop a multiple
    of 32, overlap 2 to 8)."""
    return [(n, n // ov) for n in sizes for ov in range(2, 9)
            if n % ov == 0 and PG.gl_project_available(n, n // ov, (0.5, 0.25))]


# ------------------------------------------------------------ rules and plans
def test_route_and_plan_at_every_seven_shape():
    """42 shapes, each on the smooth route with a tile a multiple of ``2
    overlap``, teams within the route's, a block within shared memory and
    any chain; 1408/352 keeps the product route and its chain limit."""
    shapes = gate_shapes(SEVEN_SIZES)
    assert len(shapes) == 42 and (224, 32) in shapes and (4032, 2016) in shapes
    for n, hop in shapes:
        ov = n // hop
        assert PG.gl_step_route(n, hop) == "smooth", (n, hop)
        tile_t, teams = PG._step_fft_plan(n, hop)
        assert tile_t % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n), (n, hop)
        assert PG._fft_smem_bytes(tile_t, ov, hop, teams) <= FF.MAX_SMEM
        assert PG.gl_max_chain(n, hop, 64) == 64
    assert PG._step_fft_plan(896, 224) == (24, 4) and PG._step_fft_plan(896, 128) == (42, 4)
    assert PG._step_fft_plan(1568, 224) == (28, 2) and PG._step_fft_plan(672, 96) == (42, 4)
    assert PG._step_fft_plan(672, 224) == (18, 4) and PG._step_fft_plan(4032, 2016) == (8, 1)
    assert PG.gl_step_route(1408, 352) == "product" and PG._step_fft_plan(1408, 352) is None
    assert PG.gl_max_chain(1408, 352, 4) == 4 and PG.gl_max_chain(1408, 352, 64) == 13


def test_one_coverage_question_for_c_d_i_and_j():
    """C, D and I (``gl_step_route``) and J (``_fullk_route``) take the same
    route at every shape the gates take from 64 to 4096, and their plans are
    ``_fft_plan`` over their own layouts and blocks an SM."""
    shapes = gate_shapes(range(64, FF.FFT_MAX + 1, 2))
    routes = {}
    for n, hop in shapes:
        ov = n // hop
        route = PG.gl_step_route(n, hop)
        assert PG._fullk_route(n, hop) == route, (n, hop)
        routes[route] = routes.get(route, 0) + 1
        c = PG._fft_plan(n, hop, lambda t, m: PG._fft_smem_bytes(t, ov, hop, m), PG.STEP_SEVEN_BLOCKS)
        j = PG._fft_plan(n, hop, lambda t, m: PG._fullk_fft_smem_bytes(t + ov, hop, n, m), PG.FULLK_SEVEN_BLOCKS)
        if route == "product":
            assert c is None and j is None
            continue
        assert c == PG._step_fft_plan(n, hop) and j == PG._pick_fullk_fft_block(n, hop)[1:]
        assert PG._fullk_plan(n, hop)[0] == route
    assert routes["smooth"] == 91 + 42 and routes["fft"] > 0 and routes["product"] > 0


def test_the_step_plan_reads_the_blocks_the_registers_allow(monkeypatch):
    """C's radix-7 plan passes ``STEP_SEVEN_BLOCKS`` to
    ``class_plan_smooth``; its 5-smooth plan keeps four blocks an SM."""
    seen = []

    def spy(n_fft, hop, smem, widest=64, blocks=2, analysis_pairs=None):
        seen.append((n_fft, blocks, analysis_pairs(2 * (n_fft // hop))))
        return 2 * (n_fft // hop), 1

    monkeypatch.setattr(PG, "class_plan_smooth", spy)
    PG._step_fft_plan.cache_clear()
    try:
        assert PG._step_fft_plan(896, 224) == (8, 1) and PG._step_fft_plan(768, 192) == (8, 1)
    finally:
        PG._step_fft_plan.cache_clear()
    assert seen == [(896, PG.STEP_SEVEN_BLOCKS, 4), (768, 4, 4)]
    assert 1 <= PG.STEP_SEVEN_BLOCKS <= 4


# ---------------------------------------------------------- against the JAX package
@pytest.mark.parametrize("window,iters,tol", [("hann", 1, 1e-4), ("hann", 4, 1e-3), ("hamming", 1, 1e-4)])
def test_seven_step_vs_pallas_kernels(window, iters, tol):
    """C (iters 1) and D (a chain of 4) on the radix-7 instance's plain
    version at 896/224 against the JAX kernels, interior frames under hann,
    every frame under hamming; the new angles weighted by |R|."""
    n_fft, hop = 896, 224
    assert PG.gl_step_route(n_fft, hop) == "smooth"
    w, taps, mag, st, _ = step_case(window, n_fft, hop)
    st = real_at_nyquist(st)
    jo = run_jax(w, taps, mag, st, n_fft, hop, iters)
    po = run_port(w, taps, mag, st, n_fft, hop, iters)
    m = iters * (n_fft // hop - 1) if window == "hann" else 0
    frames = slice(m, mag.shape[1] - m)
    assert projection_err(po, jo, frames) <= tol
    scale = max(np.abs(jo[2]).max(), np.abs(jo[3]).max())
    wgt = np.minimum(1.0, np.sqrt(po[2] ** 2 + po[3] ** 2) / scale)
    for i in (0, 1):
        assert (np.abs(po[i] - jo[i]) * wgt)[:, frames].max() <= 10 * tol
    assert np.abs(np.sqrt(po[0] ** 2 + po[1] ** 2) - 1.0).max() <= 1e-5


def test_seven_projection_vs_pallas_kernel():
    """I at 896/224 against the JAX kernel (interior frames under hann), and
    equal to C's projection from tprev = 0 bit for bit."""
    import jax.numpy as jnp

    n_fft, hop = 896, 224
    w, taps, mag, st, env = step_case("hann", n_fft, hop)
    st = real_at_nyquist(st)
    jre, jim = JG.gl_project(*[jnp.asarray(a) for a in (mag, st[0], st[1])], n_fft, hop, taps,
                             jnp.asarray(w), interpret=True)
    pre, pim = PG.gl_project(*tensors(mag, st[0], st[1]), n_fft, hop, taps, *tensors(w))
    m = n_fft // hop - 1
    got, ref = [None, None, t2n(pre), t2n(pim)], [None, None, np.asarray(jre), np.asarray(jim)]
    assert projection_err(got, ref, slice(m, mag.shape[1] - m)) <= 1e-4
    z = torch.zeros_like(pre)
    step = PG.gl_momentum_step_reference(*tensors(mag, st[0], st[1]), z, z, env, n_fft, hop, taps, MOM)
    assert torch.equal(step[2], pre) and torch.equal(step[3], pim)


# --------------------------------------------------------- against float64
@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("n_fft,hop", ORACLE_SHAPES)
def test_seven_step_vs_float64_oracle_and_product(n_fft, hop, iters, monkeypatch):
    """C and D's plain versions on the radix-7 schedule: every frame within
    1e-5 of the float64 oracle (the new angles weighted by |u| too), the
    projection bit for bit the schedule spelled out, and no further from
    the oracle than the product route's plain version."""
    assert PG.gl_step_route(n_fft, hop) == "smooth"
    w, taps, mag, st, env = step_case("hann", n_fft, hop)
    args = tensors(mag, *st)

    def plain():
        return [t2n(o) for o in PG.gl_momentum_step_reference(*args, env, n_fft, hop, taps, MOM, iters)]
    oracle = [o.numpy() for o in PG.gl_momentum_step_oracle(*args, env, n_fft, hop, taps, MOM, iters)]
    po = plain()
    err = projection_err(po, oracle)
    assert err <= 1e-5
    if iters == 1:
        u = np.sqrt((oracle[2] - MOM * st[2]) ** 2 + (oracle[3] - MOM * st[3]) ** 2)
        for i in (0, 1):
            assert (np.abs(po[i] - oracle[i]) * u / u.max()).max() <= 1e-5
        rre, rim = PG._project_fft(*args[:3], env, n_fft, hop, taps, smooth=True)
        assert np.array_equal(po[2], t2n(rre)) and np.array_equal(po[3], t2n(rim))
    on_product(monkeypatch)
    prod = plain()
    assert not np.array_equal(prod[2], po[2]) and err <= projection_err(prod, oracle)


@pytest.mark.parametrize("n_fft,hop", ORACLE_SHAPES)
def test_seven_projection_vs_float64_oracle_and_product(n_fft, hop, monkeypatch):
    """I's plain version on the radix-7 schedule within 1e-5 of the float64
    oracle on every frame, and no further from it than the product's."""
    w, taps, mag, st, env = step_case("hann", n_fft, hop)
    z = torch.zeros(mag.shape)
    oo = PG.gl_momentum_step_oracle(*tensors(mag, st[0], st[1]), z, z, env, n_fft, hop, taps, MOM)
    ref = [None, None, oo[2].numpy(), oo[3].numpy()]

    def plain():
        re, im = PG.gl_project_reference(*tensors(mag, st[0], st[1]), n_fft, hop, taps, *tensors(w))
        return [None, None, t2n(re), t2n(im)]
    err = projection_err(plain(), ref)
    assert err <= 1e-5
    on_product(monkeypatch)
    assert err <= projection_err(plain(), ref)


# ------------------------------------------------------------- the invert
def test_griffin_lim_on_the_seven_schedule_converges_like_the_eager_loop(monkeypatch):
    """``STFT(896, 224).griffin_lim(fused=True)`` on the CPU runs chains of D
    and single C steps on the radix-7 plain route, ends within the eager
    loop's spectral-convergence margin from the same seed, and counts no
    launch off the card."""
    calls = []
    real = PG._project_fft

    def spy(*a, **k):
        calls.append(k.get("smooth"))
        return real(*a, **k)

    monkeypatch.setattr(PG, "_project_fft", spy)
    st = PT.STFT(n_fft=896, hop_length=224, device="cpu")
    st.gl_iterations = 9
    x = torch.as_tensor(make_audio(71, batch=2, n=20000)[:, 0])
    m = st(x).abs()

    def sc(y):
        R = st(y).abs()[..., : m.shape[-2], :]
        return (torch.linalg.norm(R - m) / torch.linalg.norm(m)).item()

    PG.reset_launches()
    s_k = sc(st.griffin_lim(m, generator=torch.Generator().manual_seed(157), fused=True))
    assert calls == [True] * 9                  # two chains of 4 and one step: every iteration radix 7
    s_e = sc(st.griffin_lim(m, generator=torch.Generator().manual_seed(157), fused=False))
    assert s_k < max(1.15 * s_e, s_e + 0.02)
    assert not any(PG.launches.values()) and not any(PG.routes.values())
