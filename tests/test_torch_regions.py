"""Dispatch-region conformance of the port (twin of ``tests/test_regions.py``).

Every numeric ``auto`` gate of the port lives in
``acids_transforms_tpu_torch/dispatch_regions.json`` (loaded by
``regions.py``), measured on the H100 by ``tools/sweep_regions.py``.  The
planners (``streaming.plan_*``, ``fuse._kernel_preferred``,
``fuse._fit_region``) are the decisions the entry points execute; this suite
holds them against expectations stated here, across the port's own matrix,
planning for the card (``device="cuda"``: a plan needs no card) without
allocating a session.  It also holds the table to its provenance: every value
has a ``_why`` naming the card, and no value equals the JAX package's TPU
table unless stated below as a coincidence of measurement.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import fuse, regions
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as SS

F = 513
GIB = 1 << 30


def _chain(n_fft=1024, hop=256, mode=None, feature=False, ola_hop=None):
    ch = PT.OverlapAdd(n_fft, ola_hop or hop, device="cpu") + PT.RealtimeSTFT(
        n_fft=n_fft, hop_length=hop, device="cpu", **({"inversion_mode": mode} if mode else {}))
    if feature:
        ch = ch + PT.Magnitude(mode=None, contrast="log1p", mel=True, n_fft=n_fft, device="cpu")
    return ch


def test_table_loads_and_values_measured():
    t = regions.table()
    s = t["streaming"]
    assert s["angle_cap_bytes"] == 6307184640 and regions.angle_cap_bytes() == 6307184640
    assert s["sinebank_cap_bytes"] == 8368685056 and regions.sinebank_cap_bytes() == 8368685056
    # every session route won at B = 1, 8, 64 and 256, at 1024/256 and 1200/300: no cap
    assert "1200/300" in s["_batch_why"]
    assert s["batch_caps"] == {"complex": None, "complex_decode": None, "encode": None, "pghi": None,
                               "pghi_gl": None, "random": None}
    assert all(regions.batch_cap(m) is None for m in s["batch_caps"])
    assert t["fuse_fit"]["fullk_n_fft_max"] == 4096 == regions.fit_fullk_max_n_fft()
    # the magnitude's fit (F) won on the smooth route at 768/192 (0.23x) and
    # on its radix-7 instance at 896/224 (0.22x), and lost on the product
    # route at 1408/352 (1.61x); PolarIF's (H full-K) won on its smooth route
    # at 768/192 (0.17x), on its radix-7 instance at 896/224 (0.16x) and on
    # its product route at 1408/352 (0.85x)
    assert t["fuse_fit"]["melspec_fullk_routes"] == ["fft", "smooth"]
    assert t["fuse_fit"]["repr_fullk_routes"] == ["fft", "smooth", "product"]
    ff = t["fuse_forward"]
    # (region, n_fft_min, routes): at 64/32 the kernel lost for the
    # cosine-sum magnitude (1.05x) and Polar (1.11x, 1.10x); MFCC won there
    # (0.95x, 0.98x and 1.05x sweeps before: run noise near 1); the full-K
    # product route lost at 1408/352 for the magnitude (1.88x), PolarIF
    # (1.24x) and Polar (1.56x); every pattern's smooth route won at 768/192
    # (0.16-0.25x) and its radix-7 instance at 896/224 (0.15-0.23x); the
    # factored route at 1408/352 for the cosine-sum magnitude, MFCC, PolarIF
    # and Polar (0.55x, 0.66x, 0.50x, 0.59x)
    smooth = ["fft", "smooth", "factored"]
    for r, lo, routes in ((ff["melspec_taps"], 128, smooth), (ff["melspec_fullk"], 64, ["fft", "smooth"]),
                          (ff["repr_if"]["taps"], 64, smooth), (ff["repr_if"]["fullk"], 64, ["fft", "smooth"]),
                          (ff["repr_phase_imag"]["taps"], 128, smooth),
                          (ff["repr_phase_imag"]["fullk"], 128, ["fft", "smooth"]), (ff["mfcc"], 64, smooth)):
        assert set(r) == {"_why", "n_fft_min", "n_fft_max", "routes"}   # no overlap key
        assert (r["n_fft_min"], r["n_fft_max"], r["routes"]) == (lo, 4096, routes)
        assert "896/224" in r["_why"] and "1408/352" in r["_why"]


def _numbers(node, path=()):
    """``(path, value, the why that documents it)`` of every value of the table."""
    whys = {"angle_cap_bytes": "_angle_why", "sinebank_cap_bytes": "_sinebank_why", "batch_caps": "_batch_why"}
    for k, v in node.items():
        if k.startswith("_"):
            continue
        if isinstance(v, dict) and "_why" not in v and k != "batch_caps":
            yield from _numbers(v, path + (k,))
        elif isinstance(v, dict) and k == "batch_caps":
            for m, c in v.items():
                yield path + (k, m), c, node["_batch_why"]
        elif isinstance(v, dict):
            for kk, vv in v.items():
                if not kk.startswith("_"):
                    yield path + (k, kk), vv, v["_why"]
        else:
            yield path + (k,), v, node.get(whys.get(k, "_why"))


def test_every_value_has_a_why_naming_the_h100():
    rows = list(_numbers(regions.table()))
    assert len(rows) == 32
    routes = {"fft", "smooth", "product", "factored"}
    for path, value, why in rows:
        assert value is None or isinstance(value, (bool, int)) or (
            isinstance(value, list) and value[0] == "fft" and set(value) <= routes), path
        assert why and "H100" in why and " W" in why, path


def _jax_table():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "acids_transforms_tpu", "dispatch_regions.json")) as f:
        return json.load(f)


#: values equal to the TPU table's by measurement, not by copy: 4096 is the
#: largest n_fft both sweeps measured, and RT-PGHI's session kernel won at
#: every batch on both chips
COINCIDE = {
    ("fuse_forward", "melspec_taps", "n_fft_max"), ("fuse_forward", "mfcc", "n_fft_max"),
    ("streaming", "batch_caps", "pghi"),
}


def test_no_value_is_the_tpu_tables_by_copy():
    jax_t = _jax_table()
    port = {p: v for p, v, _ in _numbers(regions.table())}

    def jax_value(path):
        node = jax_t
        for k in path:
            if not isinstance(node, dict) or k not in node:
                return "absent"
            node = node[k]
        return node

    same = {p for p, v in port.items() if jax_value(p) == v}
    assert same == COINCIDE
    # the TPU's crossovers and its nyquist-depad lane layout are not the card's
    assert regions.table()["fuse_forward"]["melspec_fullk"].get("requires_nyq_depad") is None


# ---------------------------------------------------------- streaming plans
ROUNDTRIP_BATCH_MATRIX = [
    # (inversion_mode, batch, the plan on the card): no cap, the routes won
    # at B = 1, 8, 64 and 256
    (None, 1, "complex"), (None, 256, "complex"), ("pghi", 1, "pghi"), ("pghi", 256, "pghi"),
    ("pghi_gl", 1, "pghi_gl"), ("pghi_gl", 256, "pghi_gl"), ("random", 64, "random"), ("random", 512, "random"),
    ("sinebank", 1, "sinebank"), ("sinebank", 256, "sinebank"),
]


@pytest.mark.parametrize("mode,batch,expected", ROUNDTRIP_BATCH_MATRIX)
def test_roundtrip_plan_matrix(mode, batch, expected):
    ch = _chain(mode=mode)
    shape = (batch, 8 * 4096) if batch > 1 else (8 * 4096,)
    assert PS.plan_roundtrip(ch, shape, 4096, mode, device="cuda") == expected
    # on the CPU auto takes no kernel; the sinebank's closed form (torch ops) stays
    assert PS.plan_roundtrip(ch, shape, 4096, mode, device="cpu") == ("sinebank" if mode == "sinebank" else "generic")
    assert PS.plan_roundtrip(ch, shape, 4096, mode, backend="fused", device="cpu") == expected
    assert PS.plan_roundtrip(ch, shape, 4096, mode, backend="generic", device="cuda") == "generic"


def test_invert_plan_matrix():
    for mode in ("pghi", "pghi_gl", "random", "sinebank"):
        for batch in (8, 256):
            assert PS.plan_invert(_chain(mode=mode), (batch, 128, F), 16, mode, device="cuda") == mode
    ch = _chain()
    for shape in ((128, F), (4, 128, F), (256, 128, F)):
        assert PS.plan_invert(ch, shape, 16, None, y_is_complex=True, device="cuda") == "complex"
        assert PS.plan_invert(ch, shape, 16, None, y_is_complex=True, device="cpu") == "generic"
    # a Magnitude tail means real features, not a complex spectrum
    assert PS.plan_invert(_chain(feature=True), (8, 128, F), 16, None, y_is_complex=True, device="cuda") == "generic"


def test_encode_plan_matrix():
    ch = _chain()
    for batch in (1, 8, 256):
        assert PS.plan_forward(ch, (batch, 8 * 4096), 4096, device="cuda") == "fused"
    assert PS.plan_forward(ch, (8, 8 * 4096), 4096, has_state=True, device="cuda") == "generic"
    assert PS.plan_forward(ch, (8, 8 * 4096), 4096, device="cpu") == "generic"
    with pytest.raises(ValueError, match="fused"):
        PS.plan_forward(ch, (8, 8 * 4096), 4096, has_state=True, backend="fused", device="cuda")


@pytest.mark.parametrize("mode", ["random", "pghi", "pghi_gl"])
def test_angle_footprint_gate(mode):
    """A phaseless session whose ``(B, T, F)`` float32 angle buffer exceeds
    the cap runs the generic scan under ``auto`` (it draws chunk by chunk);
    ``fused`` still forces the session.  Planned only: nothing is allocated."""
    ch = _chain(mode=mode)
    big, fits = (64, 2 ** 16, F), (64, 2 ** 15, F)       # 8.6 GB and 4.3 GB of angles
    assert 64 * 2 ** 16 * F * 4 > regions.angle_cap_bytes() > 64 * 2 ** 15 * F * 4
    assert PS.plan_invert(ch, big, 16, mode, device="cuda") == "generic"
    assert PS.plan_invert(ch, big, 16, mode, backend="fused", device="cuda") == mode
    assert PS.plan_invert(ch, fits, 16, mode, device="cuda") == mode
    # the roundtrip twin: the footprint from the signal's length
    assert PS.plan_roundtrip(ch, (64, 2 ** 16 * 256), 4096, mode, device="cuda") == "generic"
    assert PS.plan_roundtrip(ch, (64, 2 ** 15 * 256), 4096, mode, device="cuda") == mode
    assert PS.plan_roundtrip(_chain(mode=mode, feature=True), (64, 2 ** 16 * 256), 4096, mode,
                             device="cuda") == "generic"


def test_sinebank_footprint_gate():
    """The closed form holds ``(B, T, n_fft)`` float32 frames; above the cap
    ``auto`` runs the generic scan on either device."""
    ch = _chain(mode="sinebank")
    big, small = (64, 2 ** 16, F), (2, 128, F)              # 17 GB of frames, and 1 MB
    assert 64 * 2 ** 16 * 1024 * 4 > regions.sinebank_cap_bytes()
    for dev in ("cuda", "cpu"):
        assert PS.plan_invert(ch, big, 16, "sinebank", device=dev) == "generic"
        assert PS.plan_invert(ch, big, 16, "sinebank", backend="fused", device=dev) == "sinebank"
        assert PS.plan_invert(ch, small, 16, "sinebank", device=dev) == "sinebank"
        assert PS.plan_roundtrip(ch, (64, 2 ** 16 * 256), 4096, "sinebank", device=dev) == "generic"
    # the frame count that decides is the padded one (whole chunks)
    cap_frames = regions.sinebank_cap_bytes() // (1024 * 4)
    edge = (cap_frames - 1,) + (F,)
    assert PS.plan_invert(ch, (1,) + edge, 1, "sinebank", device="cuda") == "sinebank"
    assert PS.plan_invert(ch, (1,) + edge, cap_frames + 16, "sinebank", device="cuda") == "generic"


def test_layout_gates_fall_back():
    ch = _chain(mode="sinebank", ola_hop=512)
    assert PS.plan_invert(ch, (2, 128, F), 16, "sinebank", device="cuda") == "generic"
    ch2 = PT.OverlapAdd(1000, 250, device="cpu") + PT.RealtimeSTFT(n_fft=1000, hop_length=250, device="cpu")
    assert PS.plan_roundtrip(ch2, (8, 8000), 4000, None, device="cuda") == "generic"


# ------------------------------------------------------------- fuse regions
def test_fuse_region_helpers_match_table():
    assert regions.melspec_region_ok(256, 64, True) and regions.melspec_region_ok(4096, 2048, True)
    assert regions.melspec_region_ok(1024, 128, True) and regions.melspec_region_ok(768, 192, True)
    assert regions.melspec_region_ok(128, 32, True) and not regions.melspec_region_ok(8192, 2048, True)
    # 64/32: the cosine-sum kernel lost (1.03x), the full-K one won (0.78x)
    assert not regions.melspec_region_ok(64, 32, True) and regions.melspec_region_ok(64, 32, False)
    assert regions.repr_region_ok(64, 32, True, "if") and not regions.repr_region_ok(64, 32, True, "phase")
    assert regions.mfcc_region_ok(64, 32) and regions.mfcc_region_ok(128, 32)
    # full-K magnitude: the FFT and smooth routes (its product route lost at
    # 1408: 1.88x; at 768 the smooth route won, 0.16x, at 896 its radix-7
    # instance, 0.17x)
    assert regions.melspec_region_ok(2048, 512, False) and regions.melspec_region_ok(768, 192, False)
    assert regions.melspec_region_ok(1920, 480, False) and not regions.melspec_region_ok(1408, 352, False)
    assert regions.melspec_region_ok(896, 224, False) and regions.melspec_region_ok(896, 224, True)
    assert regions.melspec_region_ok(1408, 352, True)                            # A factored: 0.56x
    # the representations: the smooth route won at 768 (0.24-0.25x) and on its
    # radix-7 instance at 896 (0.22-0.23x), the full-K product route lost at
    # 1408 (PolarIF 1.24x, Polar 1.56x), the factored one won (0.50x, 0.59x)
    assert regions.repr_region_ok(768, 192, False, "if") and regions.repr_region_ok(896, 224, False, "if")
    assert regions.repr_region_ok(768, 192, False, "phase") and regions.repr_region_ok(768, 192, True, "phase")
    assert regions.repr_region_ok(1920, 480, False, "phase") and regions.repr_region_ok(896, 224, False, "phase")
    assert not regions.repr_region_ok(1408, 352, False, "phase") and not regions.repr_region_ok(1408, 352, False, "if")
    assert regions.repr_region_ok(1408, 352, True, "phase") and regions.repr_region_ok(1408, 352, True, "if")
    assert regions.repr_region_ok(512, 128, True, "imag") and regions.repr_region_ok(4096, 1024, False, "imag")
    assert regions.mfcc_region_ok(1024, 256) and regions.mfcc_region_ok(768, 192) and regions.mfcc_region_ok(896, 224)
    assert regions.mfcc_region_ok(1408, 352)                                     # MFCC factored: 0.66x
    assert not regions.mfcc_region_ok(8192, 2048)
    assert regions.fit_fullk_region_ok(4096) and regions.fit_fullk_region_ok(64)
    assert regions.fit_fullk_region_ok(768) and regions.fit_fullk_region_ok(896)
    assert not regions.fit_fullk_region_ok(1408)
    assert not regions.fit_fullk_region_ok(8192)
    assert regions.fit_fullk_region_ok(768, two_channel=True) and regions.fit_fullk_region_ok(896, two_channel=True)
    assert regions.fit_fullk_region_ok(1408, two_channel=True)                  # H full-K product: 0.85x


def _fuse_chains(n_fft, hop):
    d = dict(device="cpu")
    return {
        "melspec_taps": PT.Mono(**d) + PT.STFT(n_fft=n_fft, hop_length=hop, **d) + PT.Magnitude(
            mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft, **d),
        "melspec_fullk": PT.Mono(**d) + PT.DGT(n_fft=n_fft, hop_length=hop, **d) + PT.Magnitude(
            mode="unipolar", contrast="log1p", mel=False, n_fft=n_fft, **d),
        "if_fullk": PT.Mono(**d) + PT.DGT(n_fft=n_fft, hop_length=hop, **d) + PT.PolarIF(
            magnitude_args={"n_fft": n_fft}, **d),
        "phase_fullk": PT.Mono(**d) + PT.DGT(n_fft=n_fft, hop_length=hop, **d) + PT.Polar(
            magnitude_args={"n_fft": n_fft}, **d),
        "phase_taps": PT.STFT(n_fft=n_fft, hop_length=hop, **d) + PT.Polar(magnitude_args={"n_fft": n_fft}, **d),
        "mfcc": PT.Mono(**d) + PT.MFCC(n_fft=n_fft, hop_length=hop, **d),
    }


@pytest.mark.parametrize("n_fft,hop,expected", [
    (1024, 256, {"melspec_taps", "melspec_fullk", "if_fullk", "phase_fullk", "phase_taps", "mfcc"}),
    (768, 192, {"melspec_taps", "melspec_fullk", "if_fullk", "phase_fullk", "phase_taps", "mfcc"}),
    (896, 224, {"melspec_taps", "melspec_fullk", "if_fullk", "phase_fullk", "phase_taps", "mfcc"}),
    # the full-K product routes lost at 1408/352 (magnitude 1.88x, PolarIF
    # 1.24x, Polar 1.56x), the factored ones won
    (1408, 352, {"melspec_taps", "phase_taps", "mfcc"}),
    (2048, 256, {"melspec_taps", "melspec_fullk", "if_fullk", "phase_fullk", "phase_taps", "mfcc"}),
    (128, 32, {"melspec_taps", "melspec_fullk", "if_fullk", "phase_fullk", "phase_taps", "mfcc"}),
    (64, 32, {"melspec_fullk", "if_fullk", "mfcc"}),      # MFCC 0.96x at 64/32 (1.05x in the sweep before)
])
def test_fuse_auto_decisions(n_fft, hop, expected):
    """``auto`` takes the kernel on a CUDA input exactly inside the regions;
    outside it runs the eager formulation, and ``kernel`` still forces the
    kernel (on a CPU tensor its plain version)."""
    chains = _fuse_chains(n_fft, hop)
    assert {k for k, c in chains.items() if fuse._kernel_preferred(c)} == expected
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((1, 2, 4 * n_fft)).astype(np.float32))
    for k, c in chains.items():
        if k not in expected and fuse.fusable(c, "kernel"):
            assert fuse.fuse_forward(c, backend="kernel")(x).shape == fuse.fuse_forward(c)(x).shape


def test_fuse_auto_consults_regions(monkeypatch):
    """Shrinking the table at run time changes the decision: the code reads
    the table, not a constant of its own."""
    chain = _fuse_chains(1024, 256)["melspec_taps"]
    assert fuse._kernel_preferred(chain)
    shrunk = json.loads(json.dumps(regions.table()))
    shrunk["fuse_forward"]["melspec_taps"]["n_fft_max"] = 512
    monkeypatch.setattr(regions, "table", lambda: shrunk)
    assert not fuse._kernel_preferred(chain)
    assert fuse._kernel_preferred(_fuse_chains(512, 128)["melspec_taps"])
    shrunk["streaming"]["batch_caps"]["random"] = 8
    assert PS.plan_roundtrip(_chain(mode="random"), (16, 8 * 4096), 4096, "random", device="cuda") == "generic"
    assert PS.plan_roundtrip(_chain(mode="random"), (8, 8 * 4096), 4096, "random", device="cuda") == "random"


def test_fit_fullk_region_consults_regions():
    """A gaussian chain fits on the kernel up to 4096 on the FFT route and
    the smooth route (768: the magnitude 0.21x, PolarIF 0.20x; 896, the
    magnitude's radix-7 instance: 0.21x); at 1408 (the magnitude's product
    route lost, 1.60x) and 8192 ``auto`` runs ``chain.fit``; PolarIF's fit
    (H full-K) takes its product route at 896 (0.55x); a window with taps
    fits on the kernel wherever it is available."""
    assert fuse._fit_region(PT.DGT(n_fft=2048, hop_length=512, device="cpu"))
    assert fuse._fit_region(PT.DGT(n_fft=768, hop_length=192, device="cpu"))
    assert fuse._fit_region(PT.DGT(n_fft=768, hop_length=192, device="cpu"), two_channel=True)
    assert fuse._fit_region(PT.DGT(n_fft=896, hop_length=224, device="cpu"))
    assert not fuse._fit_region(PT.DGT(n_fft=1408, hop_length=352, device="cpu"))
    assert fuse._fit_region(PT.DGT(n_fft=896, hop_length=224, device="cpu"), two_channel=True)
    assert not fuse._fit_region(PT.DGT(n_fft=8192, hop_length=2048, device="cpu"))
    assert fuse._fit_region(PT.STFT(n_fft=768, hop_length=192, device="cpu"))


# ------------------------------------------------- the route rule of a region
def _sweep_rows(shapes, **ratios):
    """Sweep rows as ``tools/sweep_regions.py`` records them: every shape a
    win (0.5) but the ``ratios`` given (keys ``s768`` for "768/192" ...)."""
    out = {}
    for n_fft, hop in shapes:
        key = "%d/%d" % (n_fft, hop)
        r = ratios.get("s%d" % n_fft if n_fft in (768, 896, 1408) else "", 0.5)
        out[key] = {"kernel_ms": r, "eager_ms": 1.0, "ratio": r}
    return out


def _with_table(monkeypatch, fuse_forward=None, fuse_fit=None):
    t = json.loads(json.dumps(regions.table()))
    t["fuse_forward"].update(fuse_forward or {})
    t["fuse_fit"].update(fuse_fit or {})
    monkeypatch.setattr(regions, "table", lambda: t)
    return t


def test_region_admits_a_route_only_where_a_point_of_it_won(monkeypatch):
    """768/192 and 896/224 measure the smooth route of the log-mel and MFCC
    kernels (896 on its radix-7 instance), 1408/352 their factored / product
    front end: a sweep where both smooth points win and 1408 loses admits 768
    and 896 and refuses 1408, and the other way round; a sweep where 896
    alone of them loses refuses the smooth route."""
    from acids_transforms_tpu_torch.tools import sweep_regions as tool

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    win_smooth = _sweep_rows(tool.SHAPES, s768=0.6, s896=0.7, s1408=1.4)
    win_other = _sweep_rows(tool.SHAPES, s768=1.3, s896=1.1, s1408=0.8)
    lost896 = _sweep_rows(tool.SHAPES, s768=0.6, s896=1.2, s1408=0.8)
    kinds = ("melspec_taps", "melspec_fullk", "mfcc")
    a = {k: tool.shape_region(win_smooth, card, k, k) for k in kinds}
    assert a["melspec_fullk"]["routes"] == ["fft", "smooth"] and a["melspec_taps"]["routes"] == ["fft", "smooth"]
    assert "1408/352" in a["mfcc"]["_why"] and a["mfcc"]["routes"] == ["fft", "smooth"]
    _with_table(monkeypatch, fuse_forward=a)
    for taps in (False, True):
        assert regions.melspec_region_ok(768, 192, taps) and regions.melspec_region_ok(768, 256, taps)
        assert regions.melspec_region_ok(640, 160, taps) and regions.melspec_region_ok(1024, 256, taps)
        assert regions.melspec_region_ok(896, 224, taps) and not regions.melspec_region_ok(1408, 352, taps)
    assert regions.mfcc_region_ok(896, 224) and not regions.mfcc_region_ok(1408, 352)
    chains = {n: _fuse_chains(n, n // 4) for n in (768, 896, 1408)}
    assert fuse._kernel_preferred(chains[768]["melspec_fullk"]) and fuse._kernel_preferred(chains[896]["mfcc"])
    assert not fuse._kernel_preferred(chains[1408]["melspec_fullk"])
    b = {k: tool.shape_region(win_other, card, k, k) for k in kinds}
    assert b["melspec_fullk"]["routes"] == ["fft", "product"] and b["melspec_taps"]["routes"] == ["fft", "factored"]
    _with_table(monkeypatch, fuse_forward=b)
    for taps in (False, True):
        assert not regions.melspec_region_ok(768, 192, taps) and not regions.melspec_region_ok(896, 224, taps)
        assert regions.melspec_region_ok(1408, 352, taps)
    c = {k: tool.shape_region(lost896, card, k, k) for k in kinds}
    assert c["melspec_taps"]["routes"] == ["fft", "factored"] and c["mfcc"]["routes"] == ["fft", "factored"]


def test_repr_regions_read_their_own_768_point(monkeypatch):
    """G and H take the smooth route at 768 and, on their radix-7 instance,
    at 896 as the log-mel kernels do: 768/192 and 896/224 measure it and
    1408/352 their factored / product front end, each route admitted only
    where its own points won; a representation region reads its own sweep,
    never the log-mel region's."""
    from acids_transforms_tpu_torch.tools import sweep_regions as tool

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    one = _sweep_rows(tool.SHAPES, s768=0.6, s896=0.7, s1408=1.4)
    other = _sweep_rows(tool.SHAPES, s768=1.3, s896=1.2, s1408=0.7)
    assert tool.shape_region(one, card, "w", "repr_if_fullk")["routes"] == ["fft", "smooth"]
    assert tool.shape_region(other, card, "w", "repr_if_fullk")["routes"] == ["fft", "product"]
    assert tool.shape_region(other, card, "w", "repr_phase_taps")["routes"] == ["fft", "factored"]
    assert regions.kernel_route(896, True) == "smooth" == regions.kernel_route(896, False)
    assert regions.kernel_route(1408, True) == "factored" and regions.kernel_route(1408, False) == "product"
    assert regions.kernel_route(768, False) == "smooth" and regions.kernel_route(768, True) == "smooth"
    mag = _sweep_rows(tool.SHAPES, s768=0.6, s896=0.6, s1408=1.4)
    _with_table(monkeypatch, fuse_forward={
        "melspec_fullk": tool.shape_region(mag, card, "w", "melspec_fullk"),
        "repr_if": {"taps": tool.shape_region(other, card, "w", "repr_if_taps"),
                    "fullk": tool.shape_region(other, card, "w", "repr_if_fullk")}})
    assert regions.melspec_region_ok(768, 256, False) and regions.melspec_region_ok(896, 224, False)
    assert not regions.repr_region_ok(768, 256, False, "if") and regions.repr_region_ok(1024, 256, False, "if")
    assert not regions.repr_region_ok(896, 224, True, "if") and regions.repr_region_ok(1408, 352, True, "if")


def test_fit_region_follows_the_route_rule(monkeypatch):
    """The full-K fit admits a route per family by the same rule, each from
    its own points: F (the magnitude) the smooth route where its 768 and 896
    points won and the product route where its 1408 point did, H full-K
    likewise from its own points (here the other way round)."""
    from acids_transforms_tpu_torch.tools import sweep_regions as tool

    fit = {"fit_melspec_fullk": _sweep_rows(tool.FIT_SHAPES, s768=0.6, s896=0.7, s1408=1.4),
           "fit_repr_if_fullk": _sweep_rows(tool.FIT_SHAPES, s768=1.2, s896=1.1, s1408=0.6)}
    sec = tool.fit_section(fit, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert sec["fullk_n_fft_max"] == 4096
    assert sec["melspec_fullk_routes"] == ["fft", "smooth"] and sec["repr_fullk_routes"] == ["fft", "product"]
    _with_table(monkeypatch, fuse_fit=sec)
    assert regions.fit_fullk_region_ok(768) and regions.fit_fullk_region_ok(1920)
    assert regions.fit_fullk_region_ok(896) and not regions.fit_fullk_region_ok(1408)
    assert not regions.fit_fullk_region_ok(8192)
    assert not regions.fit_fullk_region_ok(768, two_channel=True) and not regions.fit_fullk_region_ok(896, True)
    assert regions.fit_fullk_region_ok(1024, two_channel=True) and regions.fit_fullk_region_ok(1408, two_channel=True)
    dgt = PT.DGT(n_fft=768, hop_length=192, device="cpu")
    assert fuse._fit_region(dgt) and not fuse._fit_region(dgt, two_channel=True)
    assert fuse._fit_region(PT.STFT(n_fft=896, hop_length=224, device="cpu"), two_channel=True)


# -------------------------------------------------- live-dispatch coherence
def test_scan_apis_execute_their_plan():
    """On the CPU the sinebank plan is the closed form, and the scan takes
    it: it differs from the generic scan at float32 rounding only."""
    rng = np.random.default_rng(11)
    ch = _chain(512, 128, mode="sinebank")
    mag = torch.as_tensor(rng.random((2, 48, 257), dtype=np.float32))
    assert PS.plan_invert(ch, tuple(mag.shape), 16, "sinebank", device="cpu") == "sinebank"
    y_auto = PS.scan_invert(ch, mag, 16, "sinebank", generator=torch.Generator().manual_seed(1))
    y_gen = PS.scan_invert(ch, mag, 16, "sinebank", generator=torch.Generator().manual_seed(1), backend="generic")
    rel = (torch.linalg.norm(y_auto - y_gen) / torch.linalg.norm(y_gen)).item()
    assert 0 < rel < 5e-3 and rel < 1e-5


def test_planner_fuzz_never_crashes_and_respects_availability():
    """Random chains, shapes and modes: every plan is a known label, ``auto``
    never takes a session whose availability gate is false, and on the CPU
    ``auto`` takes only the generic scan or the sinebank's closed form."""
    rng = np.random.default_rng(17)
    labels = {"complex", "pghi", "pghi_gl", "random", "sinebank", "generic"}
    count = 0
    for n_fft, hop in itertools.product([256, 512, 1000, 1024, 2048], [64, 125, 128, 250, 256, 512]):
        if hop >= n_fft or n_fft % hop:
            continue
        ola_hop = hop if rng.random() < 0.8 else max(32, hop // 2)
        if n_fft % ola_hop:
            ola_hop = hop
        ch = _chain(n_fft, hop, ola_hop=ola_hop)
        for mode in [None, "random", "pghi", "pghi_gl", "sinebank"]:
            B = int(rng.choice([1, 3, 8, 64, 200]))
            L = int(rng.choice([2, 5, 17])) * 4096
            chunk = int(rng.choice([2048, 4096, 5000]))
            shape = (B, L) if B > 1 else (L,)
            for dev in ("cuda", "cpu"):
                got = PS.plan_roundtrip(ch, shape, chunk, mode, device=dev)
                assert got in labels, got
                if dev == "cpu":
                    assert got in ("generic", "sinebank")
                if got == "complex":
                    assert SS.fused_roundtrip_available(ch, chunk)
                count += 1
            T_c = max(1, chunk // hop)
            got_i = PS.plan_invert(ch, shape[:-1] + (128, n_fft // 2 + 1), T_c, mode,
                                   y_is_complex=mode is None, device="cuda")
            assert got_i in labels, got_i
            if got_i == "complex":
                assert SS.fused_complex_invert_available(ch, T_c)
            assert PS.plan_forward(ch, shape, chunk, device="cuda") in ("fused", "generic")
            count += 2
    assert count > 100
