"""The full-K Griffin-Lim step J and K's synthesis on the smooth route's
radix-7 instance: where ``frames_fft.fft_covers_smooth7(n_fft)`` and
``n_fft`` has a factor 7 (even, ``2^a 3^b 5^c 7^d``: 896, 1344, 1568, ...)
and a block fits, J runs ``csrc/glstep_fullk.cu:gl_fullk_fft_kernel<true,
true>`` and K's synthesis ``csrc/pghi.cu:pghi_synthesize_fft_kernel<true,
true>`` (``frames_irfft<true, true>`` / ``frames_rfft<true, true>``, a
radix-7 stage first), whose plain versions are
``glstep.gl_momentum_step_fullk_reference`` and
``pghi_kernel.pghi_synthesize_fused_reference`` on the smooth schedule.  C,
D and I (``glstep.gl_step_route``) take their radix-7 instance there too
(``tests/test_torch_glstep_seven.py``) and O's polish its own; 1408 = 2^7 11
keeps the product routes of J, K, C, D and I.  ``chip_smoke.py`` holds the
kernels to these plain versions on the card.

Tolerances, and why:

* J against the JAX package's Pallas kernel in interpret mode at 896/224
  within 1e-4 on the frames inside the trimmed signal: the JAX kernel
  re-frames the un-trimmed tails, another boundary rule (ROADMAP Queue 3),
  as ``test_torch_glstep_smooth.py`` holds the 5-smooth route; K's synthesis
  against the JAX package's Pallas synthesis at 896/224 within 1e-4 max-abs
  over max-abs, as ``test_torch_pghi_polish_smooth.py`` holds it;
* both plain versions against their float64 oracles
  (``gl_momentum_step_fullk_oracle``; an ``istft`` of ``mag e^{i phase}``)
  within 1e-5 of the largest value, at 896/224, at 1568/224 (radices 7 7)
  and at overlap 2 (896/448) and 7 (896/128 for J, 1568/224 for K);
* no radix-7 plain version further from the oracle than the product
  version it replaces (that route reached by sending the rule to the
  product, as ``test_torch_glstep_smooth.py`` does);
* K whatever block the card cuts the clip into: bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops.pallas import glstep as JG
from acids_transforms_tpu.ops.pallas import pghi_kernel as JK
from acids_transforms_tpu_torch.ops import windows as pwin
from acids_transforms_tpu_torch.ops.cuda import frames_fft as FF
from acids_transforms_tpu_torch.ops.cuda import glstep as PG
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PK
from acids_transforms_tpu_torch.ops.cuda import stream_step as SS
from test_torch_common import rel, t2n, tones
from test_torch_glstep_smooth import MOM, fullk_case, projection_err, tensors
from test_torch_pghi_synth_fft import _dgt, _oracle

torch.set_num_threads(1)

#: even 7-smooth sizes with a factor 7, 64 to 4096
SEVEN_SIZES = [n for n in range(64, FF.FFT_MAX + 1, 2) if FF.fft_covers_smooth7(n) and n % 7 == 0]


def j_shapes():
    """Every even 7-smooth shape with a factor 7 J's gate takes (hop a
    multiple of 32, overlap 2 to 8)."""
    return [(n, n // ov) for n in SEVEN_SIZES for ov in range(2, 9)
            if n % ov == 0 and PG.gl_fullk_available(n, n // ov)]


def k_shapes():
    """Every even 7-smooth shape with a factor 7 K's gate takes (hop a
    multiple of 4, a product tile that fits)."""
    return [(n, hop) for n in SEVEN_SIZES for hop in range(4, n // 2 + 1, 4)
            if n % hop == 0 and PK.pghi_fused_available(n, hop)]


# ------------------------------------------------------------ rules and plans
def test_j_route_and_plan_at_every_seven_shape():
    """42 shapes, each on the smooth route with a plan whose tile is a
    multiple of ``2 overlap``, ``rows = tile + overlap`` and whose block fits
    shared memory; no short clip the product block covered is lost."""
    shapes = j_shapes()
    assert len(shapes) == 42 and (224, 32) in shapes and (4032, 2016) in shapes
    for n, hop in shapes:
        ov = n // hop
        route, rows, tile_t, teams = PG._fullk_plan(n, hop)
        assert route == "smooth" and PG._fullk_route(n, hop) == "smooth", (n, hop)
        assert tile_t % (2 * ov) == 0 and rows == tile_t + ov and 1 <= teams <= FF.fft_smooth_max_teams(n)
        assert PG._fullk_fft_smem_bytes(rows, hop, n, teams) <= FF.MAX_SMEM
        old = PG._pick_fullk_block(n, hop)
        assert old is not None, (n, hop)        # the product block took every one of them
        for T in range(2, 13):
            if PG._fullk_reflection_covered(T, n, hop, old[0], old[1]):
                assert PG._fullk_reflection_covered(T, n, hop, rows, tile_t), (n, hop, T)
    assert PG._fullk_plan(896, 224) == ("smooth", 28, 24, 4)
    assert PG._fullk_plan(1568, 224) == ("smooth", 35, 28, 2)
    assert PG._fullk_plan(4032, 2016) == ("smooth", 10, 8, 1)


def test_k_route_and_plan_at_every_seven_shape():
    """Every shape K's gate takes at an even 7-smooth n_fft with a factor 7
    is on the smooth route, with a plan of ``rows`` a multiple of ``2
    overlap`` whose block fits shared memory."""
    shapes = k_shapes()
    assert len(shapes) == 321 and (896, 224) in shapes and (1344, 336) in shapes
    for n, hop in shapes:
        ov = n // hop
        assert PK.synth_route(n, hop) == "smooth", (n, hop)
        rows, teams = PK._synth_fft_plan(n, hop)
        assert rows % (2 * ov) == 0 and 1 <= teams <= FF.fft_smooth_max_teams(n)
        assert PK._synth_fft_smem_bytes(rows, hop, n, teams) <= FF.MAX_SMEM
    assert PK._synth_fft_plan(896, 224) == (48, 4) and PK._synth_fft_plan(1344, 336) == (40, 2)


def test_the_plans_read_the_blocks_the_registers_allow(monkeypatch):
    """The radix-7 plans pass ``FULLK_SEVEN_BLOCKS`` / ``SYNTH_SEVEN_BLOCKS``
    to ``class_plan_smooth``; the 5-smooth ones keep four blocks an SM."""
    seen = []

    def spy(n_fft, hop, smem, widest=64, blocks=2, analysis_pairs=None):
        seen.append((n_fft, blocks))
        return 2 * (n_fft // hop), 1

    monkeypatch.setattr(PG, "class_plan_smooth", spy)
    monkeypatch.setattr(PK, "class_plan_smooth", spy)
    for fn in (PG._pick_fullk_fft_block, PK._synth_fft_plan):
        fn.cache_clear()
    try:
        PG._pick_fullk_fft_block(896, 224)
        PG._pick_fullk_fft_block(768, 256)
        PK._synth_fft_plan(896, 224)
        PK._synth_fft_plan(768, 256)
    finally:
        for fn in (PG._pick_fullk_fft_block, PK._synth_fft_plan):
            fn.cache_clear()
    assert seen == [(896, PG.FULLK_SEVEN_BLOCKS), (768, 4), (896, PK.SYNTH_SEVEN_BLOCKS), (768, 4)]
    assert 1 <= PG.FULLK_SEVEN_BLOCKS <= 4 and 1 <= PK.SYNTH_SEVEN_BLOCKS <= 4


def test_other_kernels_keep_their_routes():
    """C, D and I take their radix-7 instance at 896/224 and 1344/336 (any
    chain), as O's polish and K's synthesis do; J, K's synthesis, C, D and I
    keep the product route (C, D and I its chain limit) at 1408/352 (2^7
    11)."""
    for n, hop in ((896, 224), (1344, 336)):
        assert PG.gl_step_route(n, hop) == "smooth" and PG._step_fft_plan(n, hop) is not None
        assert SS.session_route(n, "polish") == "smooth"
        assert PK.synth_route(n, hop) == "smooth"
        assert PG.gl_max_chain(n, hop, 64) == 64
    assert PG.gl_step_route(1408, 352) == "product" and PG._step_fft_plan(1408, 352) is None
    assert PG.gl_max_chain(1408, 352, 64) == 13 and PG.gl_max_chain(1408, 352, 4) == 4
    assert PG._fullk_plan(1344, 192)[0] == "smooth" and PG._fullk_plan(896, 224)[0] == "smooth"
    assert PG._fullk_plan(1408, 352)[0] == "product" and PK.synth_route(1408, 352) == "product"
    assert PG._pick_fullk_fft_block(1408, 352) is None and PK._synth_fft_plan(1408, 352) is None


# ---------------------------------------------------------- against the JAX package
def test_j_plain_vs_pallas_kernel_at_896():
    """J at 896/224 on the CPU (its radix-7 plain version) against the JAX
    kernel on the frames inside the trimmed signal, the angles weighted by
    |R| there too."""
    n_fft, hop = 896, 224
    w, mag, st, _ = fullk_case(n_fft, hop)
    step, to_rows, from_rows = JG.make_gl_momentum_step_fullk(jnp.asarray(mag), n_fft, hop, jnp.asarray(w), MOM,
                                                              interpret=True)
    jo = [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]
    step, to_rows, from_rows = PG.make_gl_momentum_step_fullk(*tensors(mag), n_fft, hop, *tensors(w), MOM)
    po = [t2n(from_rows(o)) for o in step(*[to_rows(a) for a in tensors(*st)])]
    first = -(-(n_fft // 2) // hop)
    inner = slice(first, mag.shape[1] - first)
    assert projection_err(po, jo, inner) <= 1e-4
    scale = max(np.abs(jo[2]).max(), np.abs(jo[3]).max())
    wgt = np.minimum(1.0, np.sqrt(po[2] ** 2 + po[3] ** 2) / scale)
    for i in (0, 1):
        assert (np.abs(po[i] - jo[i]) * wgt)[:, inner].max() <= 1e-4


def test_k_plain_vs_pallas_synthesis_at_896():
    n_fft, hop = 896, 224
    assert PK.synth_route(n_fft, hop) == "smooth" and JK.pghi_fused_available(n_fft, hop)
    dgt, mag, ang, w, _ = _dgt(n_fft, hop, tones(6000, [(220, 440), (330,)]), seed=n_fft)
    got = PK.pghi_synthesize_fused(torch.as_tensor(mag), torch.as_tensor(ang), n_fft, hop, w)
    ref = np.asarray(JK.pghi_synthesize_fused(jnp.asarray(mag), jnp.asarray(ang), n_fft, hop, dgt.inv_window,
                                              interpret=True))
    assert tuple(got.shape) == ref.shape and rel(t2n(got), ref) <= 1e-4


# --------------------------------------------------------- against float64
@pytest.mark.parametrize("n_fft,hop", [(896, 224), (1568, 224), (896, 448), (896, 128)])
def test_j_plain_vs_float64_oracle_and_product(n_fft, hop, monkeypatch):
    """J's radix-7 plain version within 1e-5 of the float64 oracle on every
    frame, the angles weighted by |u| too, its projection bit for bit the
    smooth schedule spelled out, and no further from the oracle than the
    product route's plain version."""
    assert PG._fullk_plan(n_fft, hop)[0] == "smooth"
    w, mag, st, env = fullk_case(n_fft, hop)
    args = tensors(mag, *st)
    wt = torch.as_tensor(w.copy())

    def plain():
        return [t2n(o) for o in PG.gl_momentum_step_fullk_reference(*args, env, n_fft, hop, wt, MOM)]
    oo = [o.numpy() for o in PG.gl_momentum_step_fullk_oracle(*args, env, n_fft, hop, wt, MOM)]
    po = plain()
    err = projection_err(po, oo)
    assert err <= 1e-5
    u = np.sqrt((oo[2] - MOM * st[2]) ** 2 + (oo[3] - MOM * st[3]) ** 2)
    for i in (0, 1):
        assert (np.abs(po[i] - oo[i]) * u / u.max()).max() <= 1e-5
    sig = PG._fullk_fft_signal(*args[:3], n_fft, hop, wt, smooth=True) / env.reshape(-1)
    rre, rim = FF.frames_rfft_reference(PG._trim_reflect(sig, n_fft, hop).unfold(-1, n_fft, hop), wt, smooth=True)
    assert np.array_equal(po[2], t2n(rre)) and np.array_equal(po[3], t2n(rim))
    monkeypatch.setattr(PG, "_fullk_route", lambda n_fft, hop: "product")
    prod = plain()
    assert not np.array_equal(prod[2], po[2]) and err <= projection_err(prod, oo)


@pytest.mark.parametrize("n_fft,hop", [(896, 224), (1568, 224), (896, 448)])
def test_k_plain_vs_float64_oracle_and_product(n_fft, hop, monkeypatch):
    """Unwrapped phases up to 1e4 rad, an odd frame count whose last pair
    group has no partners, silent frames and a silent clip: K's radix-7
    plain version within 1e-5 of the float64 istft, the smooth schedule
    spelled out bit for bit, and no further from the oracle than the
    product route."""
    ov = n_fft // hop
    rng = np.random.default_rng(n_fft + hop)
    T = 2 * ov * 3 + ov - 1
    w = pwin.gaussian_dgt_window(n_fft, device="cpu")
    mag = torch.as_tensor(rng.random((3, T, n_fft // 2 + 1)).astype(np.float32))
    mag[0, 4:9] = 0.0
    mag[1] = 0.0
    ph = torch.as_tensor((1e4 * rng.random(mag.shape)).astype(np.float32))
    got = PK.pghi_synthesize_fused(mag, ph, n_fft, hop, w)
    ora = _oracle(mag, ph, n_fft, hop, w).numpy()
    assert got.shape == ora.shape and torch.isfinite(got).all() and not got[1].any()
    e_seven = rel(got.double().numpy(), ora)
    assert e_seven <= 1e-5
    y = FF.overlap_add_classes(FF.frames_irfft_reference(mag * torch.cos(ph), mag * torch.sin(ph),
                                                         FF.irfft_window(w, n_fft, smooth=True), stride=ov,
                                                         smooth=True), hop)
    assert torch.equal(got, PK._finish_audio(y, w, T, n_fft, hop, None, (3,)))
    monkeypatch.setattr(PK, "synth_route", lambda *a: "product")
    prod = PK.pghi_synthesize_fused_reference(mag, ph, n_fft, hop, w)
    assert not torch.equal(prod, got) and e_seven <= rel(prod.double().numpy(), ora)


def test_k_seven_schedule_does_not_depend_on_the_block():
    """The kernel's blocks emulated at 896/224: a block owns ``rows`` output
    chunks from ``c0`` and synthesizes the frames ``c0 - 2 overlap .. c0 +
    rows - 1`` with the clip's pairs, adding the frames in class order; bit
    for bit the whole-clip plain version at the plan's height and another."""
    n_fft, hop = 896, 224
    ov = n_fft // hop
    rng = np.random.default_rng(13)
    T = 29
    mag = torch.as_tensor(rng.random((2, T, n_fft // 2 + 1)).astype(np.float32))
    ph = torch.as_tensor((300 * rng.random(mag.shape)).astype(np.float32))
    w = pwin.gaussian_dgt_window(n_fft, device="cpu")
    wsyn = FF.irfft_window(w, n_fft, smooth=True)
    re, im = mag * torch.cos(ph), mag * torch.sin(ph)
    whole = FF.overlap_add_classes(FF.frames_irfft_reference(re, im, wsyn, stride=ov, smooth=True), hop)
    n_chunks = T + ov - 1
    for rows in (PK._synth_fft_plan(n_fft, hop)[0], 2 * ov):
        y = torch.zeros((2, n_chunks * hop))
        for c0 in range(0, n_chunks, rows):
            f0 = c0 - 2 * ov
            idx = torch.arange(f0, min(c0 + rows, T))
            keep = idx >= 0
            lre = torch.where(keep[:, None], re[:, idx.clamp_min(0)], 0.0)
            lim = torch.where(keep[:, None], im[:, idx.clamp_min(0)], 0.0)
            frames = FF.frames_irfft_reference(lre, lim, wsyn, stride=ov, smooth=True)
            samples = torch.zeros((2, rows * hop))
            for c in range(ov):
                for r in range(c, frames.shape[1], ov):
                    f = f0 + r
                    if f < 0:
                        continue
                    lo = (f - c0) * hop
                    a, b = max(lo, 0), min(lo + n_fft, rows * hop)
                    if a < b:
                        samples[:, a:b] = samples[:, a:b] + frames[:, r, a - lo: b - lo]
            n_out = min(rows, n_chunks - c0) * hop
            y[:, c0 * hop: c0 * hop + n_out] = samples[:, :n_out]
        assert torch.equal(y, whole), rows


def test_nothing_counted_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions at 896/224 and
    count no launch and no route."""
    PG.reset_launches()
    PK.reset_launches()
    w, mag, st, env = fullk_case(896, 224)
    step, to_rows, from_rows = PG.make_gl_momentum_step_fullk(*tensors(mag), 896, 224, *tensors(w), MOM)
    step(*[to_rows(a) for a in tensors(*st)])
    wg = pwin.gaussian_dgt_window(896, device="cpu")
    m = torch.rand(2, 12, 449)
    PK.pghi_synthesize_fused(m, torch.rand(2, 12, 449), 896, 224, wg)
    PK.pghi_invert_fused(m, pwin.dgt_gamma(896), 896, 224, wg)
    assert not any(PG.launches.values()) and not any(PG.routes.values())
    assert not any(PK.launches.values()) and not any(PK.routes.values())
