"""The log-mel fit's statistics (kernel B, ``fused_melspec_stats`` with the
taps of a cosine-sum window) on the shared-memory FFT: where ``n_fft`` is a
power of two from 64 to 4096, B takes F's instance
(``csrc/spectral.cu:melspec_stats_kernel<., kFrontFft>``) under the taps'
own window (``frames_fft.taps_window``, float64 rounded once); every other
``n_fft`` keeps the factored front end.  The forward with taps (A) takes
E's instance by the same rule (``spectral._kernel_plan``;
``tests/test_torch_front_fft.py``).  The plain version follows the same
rule, so on a CPU tensor the route and its plain version agree;
``chip_smoke.py`` holds the kernel to it on the card.

Tolerances, and why:

* against the JAX package's factored ``fused_melspec_stats`` (its Pallas
  kernel in interpret mode, bf16x3 products) and a float64 oracle
  (``np.fft.rfft`` of the windowed frames): the sums, the largest value
  within 1e-5 of the oracle's and 1e-4 (the JAX kernel's own budget,
  ``test_torch_spectral_kernel.py``) of the JAX kernel's, the smallest
  within 1e-5 absolute;
* the FFT route's plain version against the full-K statistics under the
  taps' window: bit for bit (it is that function); value by value no
  further from the float64 oracle than the factored route's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch as patt
from acids_transforms_tpu.ops.pallas.spectral import fused_melspec_stats as jfs
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.ops.cuda.frames_fft import taps_window
from test_torch_common import chains, make_audio, t2n

torch.set_num_threads(1)
TOL = 1e-4
TAPS = {"hann": (0.5, -0.25), "hamming": (0.54, -0.23), "blackman": (0.42, -0.25, 0.04)}


def oracle(x, taps, n_fft, hop):
    """log1p |X| in float64 of the reflect-padded frames under the cosine-sum
    window of ``taps``."""
    k = np.arange(n_fft)
    w = sum((1.0 if p == 0 else 2.0) * c * np.cos(2 * np.pi * p * k / n_fft) for p, c in enumerate(taps))
    xp = np.pad(x.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)], mode="reflect")
    idx = np.arange(1 + x.shape[-1] // hop)[:, None] * hop + k[None, :]
    return np.log1p(np.abs(np.fft.rfft(xp[:, idx] * w, axis=-1)))


@pytest.mark.parametrize("wname", ["hann", "hamming"])
@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256)])
def test_fft_route_plain_version_vs_pallas_and_oracle(n_fft, hop, wname):
    taps = TAPS[wname]
    x = make_audio(40 + n_fft // 256, batch=2, n=9000)[:, 0]
    sp = pk.fused_melspec_stats(torch.as_tensor(x), n_fft, hop, "log1p", taps=taps)
    sj = jfs(jnp.asarray(x), n_fft, hop, jnp.ones((n_fft,), jnp.float32), "log1p", interpret=True, taps=taps)
    v = oracle(x, taps, n_fft, hop)
    assert sp["count"] == v.size == int(sj["count"]) and isinstance(sp["count"], int)
    for key, want in (("sum", v.sum()), ("sumsq", (v * v).sum()), ("max", v.max())):
        assert abs(float(sp[key]) - want) <= 1e-5 * abs(want), key
        assert abs(float(sp[key]) - float(sj[key])) <= TOL * abs(want), key
    assert abs(float(sp["min"]) - v.min()) <= 1e-5 and abs(float(sj["min"]) - v.min()) <= TOL
    # the route's plain version is the full-K statistics under the taps' own window
    w = torch.as_tensor(taps_window(taps, n_fft))
    full = pk.fused_melspec_stats(torch.as_tensor(x), n_fft, hop, "log1p", taps=None, window=w)
    assert all(torch.equal(sp[k], full[k]) for k in ("sum", "sumsq", "min", "max"))


@pytest.mark.parametrize("wname", ["hann", "hamming", "blackman"])
@pytest.mark.parametrize("n_fft,hop", [(512, 128), (1024, 256)])
def test_fft_route_no_further_from_the_oracle_than_the_factored_route(n_fft, hop, wname):
    """Value by value, the FFT route's ``log1p |X|`` is no further from the
    float64 oracle than the factored front end's, which it replaces for the
    fit's statistics."""
    taps = TAPS[wname]
    x = make_audio(50, batch=2, n=9000)[:, 0]
    v = oracle(x, taps, n_fft, hop)

    def err(factored):
        xt = torch.as_tensor(x)
        re, im = (pk._factored_spectrum(xt, n_fft, hop, True, taps) if factored
                  else pk._spectrum(xt, n_fft, hop, True, taps, None))
        return np.abs(t2n(torch.log1p(torch.sqrt(re * re + im * im))).astype(np.float64) - v).max()

    assert err(False) <= err(True)


def test_fit_through_the_fft_route_matches_the_eager_cascade():
    """``fuse_fit`` of the flagship chain (taps) on the CPU runs the FFT
    route's plain version; its norm agrees with ``chain.fit``."""
    _, pc = chains(n_fft=1024, hop=256, window="blackman")
    x = torch.as_tensor(make_audio(44, n=12000))
    pf = patt.fuse_fit(pc, backend="kernel")(x)
    pe = pc.fit(x)
    s = float(pe[2].norm.scale)
    assert abs(float(pf[2].norm.offset) - float(pe[2].norm.offset)) <= 1e-5 * s
    assert abs(float(pf[2].norm.scale) - s) <= 1e-5 * s


def test_route_rule_per_launch_kind():
    """With taps the statistics take the FFT route wherever ``fft_covers``,
    with F's plan, and so does the forward (A), with E's; 768/192 (2^8 3)
    and 896/224 (2^7 7, the radix-7 instance) take the smooth route, F's and
    E's plan there, and 1408/352 (2^7 11) stays factored for both, as its
    plain version does; no launch is counted on the CPU."""
    taps = TAPS["hann"]
    for n_fft in (64, 128, 256, 512, 1024, 2048, 4096):
        hop = max(32, n_fft // 4)
        assert pk._kernel_plan(n_fft, hop, taps) == pk._kernel_plan(n_fft, hop, None)
        assert pk._kernel_plan(n_fft, hop, taps)[1] > 0
        assert pk._kernel_plan(n_fft, hop, None)[1] > 0
    assert pk._kernel_plan(1024, 256, taps) == (16, 4)
    assert pk._kernel_plan(768, 192, taps) == pk._kernel_plan(768, 192, None) and pk._kernel_plan(768, 192, taps)[1]
    assert pk._kernel_plan(896, 224, taps) == pk._kernel_plan(896, 224, None) and pk._kernel_plan(896, 224, taps)[1]
    assert pk._kernel_plan(1408, 352, taps) == (pk._pick_tile(352, 4, 705), 0)
    x = torch.as_tensor(make_audio(45, batch=2, n=6000)[:, 0])
    pk.reset_launches()
    fft = pk.fused_melspec_stats_reference(x, 512, 128, "log1p", taps=taps)
    w = torch.as_tensor(taps_window(taps, 512))
    re, im = pk._spectrum(x, 512, 128, True, taps, None)
    re_w, im_w = pk._fullk_spectrum(x, 512, 128, True, w)
    assert torch.equal(re, re_w) and torch.equal(im, im_w)
    fac = pk._factored_spectrum(x, 512, 128, True, taps)
    assert not torch.equal(fac[0], re)
    # 1408/352: the factored statistics
    st = pk.fused_melspec_stats(x, 1408, 352, "log1p", taps=taps)
    re, im = pk._factored_spectrum(x, 1408, 352, True, taps)
    v = torch.log1p(torch.sqrt(re * re + im * im)).double()
    assert torch.equal(st["sum"], v.sum()) and float(fft["sum"]) > 0
    assert not any(pk.launches.values()) and not any(pk.routes.values())
    assert {"fused_melspec_stats:fft", "fused_melspec_stats:smooth", "fused_melspec_stats:factored",
            "fused_melspec:fft", "fused_melspec:smooth", "fused_melspec:factored"} <= set(pk.routes)
