"""The Griffin-Lim steps on the smooth route: where ``n_fft`` is even, ``2^a
3^b 5^c``, 64 to 4096 and no power of two (``frames_fft.fft_covers_smooth``:
768, 640, 384, ...) and a block fits, C, D and I run
``csrc/glstep.cu:gl_step_fft_kernel<true>`` and J
``csrc/glstep_fullk.cu:gl_fullk_fft_kernel<true>`` (the mixed-radix
``frames_irfft<true>`` / ``frames_rfft<true>``), whose plain versions are
``ops/cuda/glstep.py:_project_fft(..., smooth=True)`` and
``gl_momentum_step_fullk_reference`` on the smooth schedule.  At 896 = 2^7 7
and 448 = 2^6 7 C, D, I and J take their radix-7 instances
(``tests/test_torch_glstep_seven.py``, ``tests/test_torch_gl_pghi_seven.py``)
and at 1408 = 2^7 11 the product routes.  ``chip_smoke.py`` holds the
kernels to these plain versions on the card.

Tolerances, and why:

* against the JAX package's Pallas kernels in interpret mode, as
  ``test_torch_glstep_fft.py`` holds the FFT route: C and I within 1e-4 of
  the largest projection value, D (a chain of 4 of a chaotic map, fed the
  JAX side's bf16x3 rounding) within 1e-3; on the interior frames under hann
  (its edge frames are the JAX kernel's rounding over w ~ 4e-5), on every
  frame under hamming (w >= 0.08); the angles handed to both are real at
  nyquist, a real signal's: the JAX kernel keeps the nyquist bin's
  imaginary part at n_fft % 256 != 0 (384, 640, 768) and leaks it into bin
  N - 1 through the taps (ROADMAP Queue 3), which the port drops on every
  route, as the float64 oracle does.  J within 1e-4 on the frames inside the
  trimmed signal: the JAX kernel re-frames the un-trimmed tails, another
  boundary rule (ROADMAP Queue 3), which the port does not copy;
* against the float64 oracles (``gl_momentum_step_oracle``,
  ``gl_momentum_step_fullk_oracle``) within 1e-5 of the largest value on
  every frame (measured 0.9-1.8e-7 for one step, 0.8-2.5e-6 for D's four);
* no smooth plain version further from the oracle than the product route's
  plain version at the same shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import fft as jfft
from acids_transforms_tpu.ops.pallas import glstep as jk
from acids_transforms_tpu.ops.windows import gaussian_dgt_window as jgauss
from acids_transforms_tpu.ops.windows import get_window as jwin
from acids_transforms_tpu_torch.ops.cuda import frames_fft as ff
from acids_transforms_tpu_torch.ops.cuda import glstep as pk
from acids_transforms_tpu_torch.ops.cuda import stream_step as ss
from test_torch_common import make_audio, t2n

torch.set_num_threads(1)
MOM = 0.99 / 1.99
STEP_SHAPES = [(768, 192), (384, 96), (640, 160)]
FULLK_SHAPES = [(768, 256), (384, 96)]


def make_state(w, n_fft, hop, seed, n=6000):
    """Magnitudes of a seeded clip under ``w``, random unit angles and a
    random previous projection, numpy float32."""
    rng = np.random.default_rng(seed)
    x = make_audio(seed, batch=2, n=n)[:, 0]
    mag = np.abs(np.asarray(jfft.stft(jnp.asarray(x), n_fft, hop, jnp.asarray(w)))).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, mag.shape).astype(np.float32)
    tre = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    tim = (0.1 * mag * rng.standard_normal(mag.shape)).astype(np.float32)
    return mag, (np.cos(ph), np.sin(ph), tre, tim)


def tensors(*arrays):
    return [torch.as_tensor(np.array(a, copy=True)) for a in arrays]


_CASES = {}


def step_case(window, n_fft, hop):
    """(w, taps, mag, state, env) of a step case, built once."""
    key = (window, n_fft, hop)
    if key not in _CASES:
        w = np.asarray(jwin(window, n_fft))
        mag, st = make_state(w, n_fft, hop, seed=n_fft + hop)
        env = pk._env_rows(mag.shape[1], n_fft, hop, torch.as_tensor(w.copy()))
        _CASES[key] = (w, jfft.taps_for_window(w), mag, st, env)
    return _CASES[key]


def fullk_case(n_fft, hop):
    key = ("gaussian", n_fft, hop)
    if key not in _CASES:
        w = np.asarray(jgauss(n_fft))
        mag, st = make_state(w, n_fft, hop, seed=3 * n_fft + hop)
        env = pk._env_rows(mag.shape[1], n_fft, hop, torch.as_tensor(w.copy()))
        _CASES[key] = (w, mag, st, env)
    return _CASES[key]


def real_at_nyquist(st):
    """The state with its angles real at the nyquist bin (``(+-1, 0)``)."""
    are, aim = np.array(st[0], copy=True), np.array(st[1], copy=True)
    are[..., -1] = np.where(are[..., -1] < 0, -1.0, 1.0)
    aim[..., -1] = 0.0
    return (are, aim) + tuple(st[2:])


def run_port(w, taps, mag, st, n_fft, hop, iters):
    step, to_rows, from_rows = pk.make_gl_momentum_step(
        *tensors(mag), n_fft, hop, taps, *tensors(w), MOM, iters=iters)
    return [t2n(from_rows(o)) for o in step(*[to_rows(a) for a in tensors(*st)])]


def run_jax(w, taps, mag, st, n_fft, hop, iters):
    step, to_rows, from_rows = jk.make_gl_momentum_step(
        jnp.asarray(mag), n_fft, hop, taps, jnp.asarray(w), MOM, iters=iters, interpret=True)
    return [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]


def projection_err(got, ref, frames=slice(None)):
    scale = max(np.abs(ref[2]).max(), np.abs(ref[3]).max())
    return max(np.abs(np.float64(got[i][:, frames]) - np.float64(ref[i][:, frames])).max()
               for i in (2, 3)) / scale


def on_product(monkeypatch):
    """Send the plain versions down the product route at any n_fft."""
    monkeypatch.setattr(pk, "gl_step_route", lambda n_fft, hop: "product")
    monkeypatch.setattr(pk, "_fullk_route", lambda n_fft, hop: "product")


# each JAX call compiles its kernel for its shape (1-5 s), so C runs at two
# shapes (hamming at 640/160: every frame), D at 768/192 and I at 768/192
# and 384/96; the float64 oracle tests below hold C, D, I and J at every
# shape
@pytest.mark.parametrize("n_fft,hop,window,iters,tol", [
    (768, 192, "hann", 1, 1e-4), (768, 192, "hann", 4, 1e-3), (640, 160, "hamming", 1, 1e-4)])
def test_smooth_step_vs_pallas_kernels(n_fft, hop, window, iters, tol):
    """C (iters 1) and D (a chain of 4) on the smooth route against the JAX
    kernels, interior frames under hann, every frame under hamming; the new
    angles weighted by |R|."""
    assert pk.gl_step_route(n_fft, hop) == "smooth"
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


@pytest.mark.parametrize("n_fft,hop", [(768, 192), (384, 96)])
def test_smooth_projection_vs_pallas_kernel(n_fft, hop):
    """I on the smooth route against the JAX kernel (interior frames under
    hann), and equal to C's projection from tprev = 0 bit for bit."""
    w, taps, mag, st, env = step_case("hann", n_fft, hop)
    st = real_at_nyquist(st)
    jre, jim = jk.gl_project(*[jnp.asarray(a) for a in (mag, st[0], st[1])], n_fft, hop, taps,
                             jnp.asarray(w), interpret=True)
    pre, pim = pk.gl_project(*tensors(mag, st[0], st[1]), n_fft, hop, taps, *tensors(w))
    m = n_fft // hop - 1
    got, ref = [None, None, t2n(pre), t2n(pim)], [None, None, np.asarray(jre), np.asarray(jim)]
    assert projection_err(got, ref, slice(m, mag.shape[1] - m)) <= 1e-4
    z = torch.zeros_like(pre)
    step = pk.gl_momentum_step_reference(*tensors(mag, st[0], st[1]), z, z, env, n_fft, hop, taps, MOM)
    assert torch.equal(step[2], pre) and torch.equal(step[3], pim)


@pytest.mark.parametrize("n_fft,hop", FULLK_SHAPES)
def test_smooth_fullk_vs_pallas_kernel(n_fft, hop):
    """J on the smooth route against the JAX kernel on the frames inside the
    trimmed signal, the angles weighted by |R| there too."""
    assert pk._fullk_plan(n_fft, hop)[0] == "smooth"
    w, mag, st, _ = fullk_case(n_fft, hop)
    step, to_rows, from_rows = jk.make_gl_momentum_step_fullk(jnp.asarray(mag), n_fft, hop, jnp.asarray(w), MOM,
                                                              interpret=True)
    jo = [np.asarray(from_rows(o)) for o in step(*[to_rows(jnp.asarray(a)) for a in st])]
    step, to_rows, from_rows = pk.make_gl_momentum_step_fullk(*tensors(mag), n_fft, hop, *tensors(w), MOM)
    po = [t2n(from_rows(o)) for o in step(*[to_rows(a) for a in tensors(*st)])]
    first = -(-(n_fft // 2) // hop)         # the first frame inside the trimmed signal
    inner = slice(first, mag.shape[1] - first)
    assert projection_err(po, jo, inner) <= 1e-4
    scale = max(np.abs(jo[2]).max(), np.abs(jo[3]).max())
    wgt = np.minimum(1.0, np.sqrt(po[2] ** 2 + po[3] ** 2) / scale)
    for i in (0, 1):
        assert (np.abs(po[i] - jo[i]) * wgt)[:, inner].max() <= 1e-4


def _step_outputs(n_fft, hop, window, iters):
    w, taps, mag, st, env = step_case(window, n_fft, hop)
    args = tensors(mag, *st)
    plain = [t2n(o) for o in pk.gl_momentum_step_reference(*args, env, n_fft, hop, taps, MOM, iters)]
    oracle = [o.numpy() for o in pk.gl_momentum_step_oracle(*args, env, n_fft, hop, taps, MOM, iters)]
    return plain, oracle, st


@pytest.mark.parametrize("window", ["hann", "hamming"])
@pytest.mark.parametrize("iters", [1, 4])
@pytest.mark.parametrize("n_fft,hop", STEP_SHAPES)
def test_smooth_step_vs_float64_oracle(n_fft, hop, iters, window, monkeypatch):
    """C and D's plain versions on the smooth schedule: every frame within
    1e-5 of the float64 oracle, the new angles weighted by |u| too, and no
    further from it than the product route's plain version."""
    plain, oracle, st = _step_outputs(n_fft, hop, window, iters)
    err = projection_err(plain, oracle)
    assert err <= 1e-5
    if iters == 1:
        u = np.sqrt((oracle[2] - MOM * st[2]) ** 2 + (oracle[3] - MOM * st[3]) ** 2)
        for i in (0, 1):
            assert (np.abs(plain[i] - oracle[i]) * u / u.max()).max() <= 1e-5
    on_product(monkeypatch)
    product, _, _ = _step_outputs(n_fft, hop, window, iters)
    assert err <= projection_err(product, oracle)


@pytest.mark.parametrize("n_fft,hop", STEP_SHAPES)
def test_smooth_projection_vs_float64_oracle(n_fft, hop, monkeypatch):
    """I's plain version on the smooth schedule within 1e-5 of the float64
    oracle on every frame, and no further from it than the product's."""
    w, taps, mag, st, env = step_case("hann", n_fft, hop)
    z = torch.zeros(mag.shape)
    oo = pk.gl_momentum_step_oracle(*tensors(mag, st[0], st[1]), z, z, env, n_fft, hop, taps, MOM)
    ref = [None, None, oo[2].numpy(), oo[3].numpy()]

    def plain():
        re, im = pk.gl_project_reference(*tensors(mag, st[0], st[1]), n_fft, hop, taps, *tensors(w))
        return [None, None, t2n(re), t2n(im)]
    err = projection_err(plain(), ref)
    assert err <= 1e-5
    on_product(monkeypatch)
    assert err <= projection_err(plain(), ref)


@pytest.mark.parametrize("n_fft,hop", FULLK_SHAPES + [(640, 160)])
def test_smooth_fullk_vs_float64_oracle(n_fft, hop, monkeypatch):
    """J's plain version on the smooth schedule within 1e-5 of the float64
    oracle on every frame (the eager loop's boundary rule), the angles
    weighted by |u| too, and no further from it than the product's."""
    w, mag, st, env = fullk_case(n_fft, hop)
    args = tensors(mag, *st)

    def plain():
        return [t2n(o) for o in pk.gl_momentum_step_fullk_reference(*args, env, n_fft, hop, *tensors(w), MOM)]
    oo = [o.numpy() for o in pk.gl_momentum_step_fullk_oracle(*args, env, n_fft, hop, *tensors(w), MOM)]
    po = plain()
    err = projection_err(po, oo)
    assert err <= 1e-5
    u = np.sqrt((oo[2] - MOM * st[2]) ** 2 + (oo[3] - MOM * st[3]) ** 2)
    for i in (0, 1):
        assert (np.abs(po[i] - oo[i]) * u / u.max()).max() <= 1e-5
    on_product(monkeypatch)
    assert err <= projection_err(plain(), oo)


def test_the_plain_versions_take_the_smooth_schedule():
    """On the CPU the step factories run the smooth schedule's plain
    versions at 768, bit for bit the functions the kernels repeat."""
    w, taps, mag, st, env = step_case("hann", 768, 192)
    args = tensors(mag, *st)
    a = pk.gl_momentum_step_reference(*args, env, 768, 192, taps, MOM)
    b = pk._project_fft(*args[:3], env, 768, 192, taps, smooth=True)
    assert torch.equal(a[2], b[0]) and torch.equal(a[3], b[1])
    c = run_port(w, taps, mag, st, 768, 192, 1)
    assert all(np.array_equal(t2n(x), y) for x, y in zip(a, c))
    w, mag, st, env = fullk_case(768, 256)
    wt = torch.as_tensor(w.copy())
    sig = pk._fullk_fft_signal(*tensors(mag, st[0], st[1]), 768, 256, wt, smooth=True) / env.reshape(-1)
    rre, rim = ff.frames_rfft_reference(pk._trim_reflect(sig, 768, 256).unfold(-1, 768, 256), wt, smooth=True)
    j = pk.gl_momentum_step_fullk_reference(*tensors(mag, *st), env, 768, 256, wt, MOM)
    assert torch.equal(j[2], rre) and torch.equal(j[3], rim)


def test_the_route_reads_n_fft_and_hop():
    """Per kernel: C, D and I smooth at 768 (and every even 5-smooth n_fft
    the gates take) and at 896 and 448 (2^k 7: their radix-7 instance),
    product at 1408 (2^7 11), fft at 512, any chain off the product route;
    J likewise."""
    for n_fft, hop, route_cdi, route_j in ((768, 192, "smooth", "smooth"), (768, 256, "smooth", "smooth"),
                                           (896, 224, "smooth", "smooth"), (448, 112, "smooth", "smooth"),
                                           (1408, 352, "product", "product"), (512, 128, "fft", "fft"),
                                           (1024, 256, "fft", "fft")):
        assert pk.gl_step_route(n_fft, hop) == route_cdi, (n_fft, hop)
        assert (pk.gl_max_chain(n_fft, hop, 64) == 64) == (route_cdi != "product")
        assert pk._fullk_plan(n_fft, hop)[0] == route_j, (n_fft, hop)
    assert pk._step_fft_plan(896, 224) == (24, 4) and pk._pick_fullk_fft_block(896, 224) == (28, 24, 4)
    assert pk._step_fft_plan(1408, 352) is None and pk._pick_fullk_fft_block(1408, 352) is None
    assert pk._step_fft_plan(768, 192) == (56, 4) and pk._fullk_plan(768, 256) == ("smooth", 15, 12, 4)
    n_shapes = 0
    for n_fft in range(64, 4097, 2):
        if not ff.fft_covers_smooth(n_fft):
            continue
        for ov in range(2, 9):
            hop = n_fft // ov
            if n_fft % ov or hop % 32:
                continue
            n_shapes += 1
            assert pk.gl_step_route(n_fft, hop) == "smooth" and pk._fullk_plan(n_fft, hop)[0] == "smooth"
            tile_t, teams = pk._step_fft_plan(n_fft, hop)
            assert tile_t % (2 * ov) == 0 and 1 <= teams <= ff.fft_smooth_max_teams(n_fft)
            assert pk._fft_smem_bytes(tile_t, ov, hop, teams) <= ff.MAX_SMEM
            _, rows, tile_j, teams_j = pk._fullk_plan(n_fft, hop)
            assert tile_j % (2 * ov) == 0 and rows == tile_j + ov and 1 <= teams_j <= ff.fft_smooth_max_teams(n_fft)
            assert pk._fullk_fft_smem_bytes(rows, hop, n_fft, teams_j) <= ff.MAX_SMEM
            for T in range(2, 13):    # a short clip the product block covered stays covered
                old = pk._pick_fullk_block(n_fft, hop)
                if old is not None and pk._fullk_reflection_covered(T, n_fft, hop, old[0], old[1]):
                    assert pk._fullk_reflection_covered(T, n_fft, hop, rows, tile_j), (n_fft, hop, T)
    assert n_shapes == 91


def test_class_plan_smooth_counts_the_analysis():
    """The analysis term: the plan maximises blocks an SM x frames over the
    rounds of pair FFTs, the synthesis's and the analysis's; without it the
    existing callers' picks stay as they were."""
    n_fft, hop = 768, 192
    ov = n_fft // hop

    def smem(t, teams):
        return pk._fft_smem_bytes(t, ov, hop, teams)

    def score(rows, teams, analysis):
        b = smem(rows, teams)
        rounds = ov * -(-(rows // (2 * ov) + 1) // teams) + (-(-(rows // 2) // teams) if analysis else 0)
        return min(4, ff.SM_SMEM // (b + 1024)) * rows / rounds

    cands = [(r, t) for t in (1, 2, 4) for r in range(2 * ov, 65, 2 * ov) if smem(r, t) <= ff.MAX_SMEM]
    for analysis in (False, True):
        pick = ff.class_plan_smooth(n_fft, hop, smem, blocks=4,
                                    analysis_pairs=(lambda t: t // 2) if analysis else None)
        assert score(*pick, analysis) == max(score(r, t, analysis) for r, t in cands)
    # J's pick at 768/256 moves with the analysis term (42 -> 12 frames: the
    # faster of the two on an H100, chip_smoke.py's plan sweep)
    picks = [ff.class_plan_smooth(768, 256, lambda t, teams: pk._fullk_fft_smem_bytes(t + 3, 256, 768, teams),
                                  blocks=4, analysis_pairs=a) for a in (None, lambda t: t // 2)]
    assert picks == [(42, 4), (12, 4)]
    # the session plans (no analysis term) as the decode and roundtrip sweeps picked them
    assert ss._roundtrip_plan(1200, 300) == (16, 2) and ss._decode_plan(1200, 300) == (40, 2)
    assert ss._decode_plan(960, 240) == (24, 4) and ss._decode_plan(768, 192) == (24, 4)
