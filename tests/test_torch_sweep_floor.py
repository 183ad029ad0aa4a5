"""Kernel T, the floor sweep's stage prefixes of A (``melspec_forward_stage``):
each plain prefix against the JAX package, on the CPU.

The stages that are a function the JAX package computes are held against its
Pallas kernel ``fused_melspec`` in interpret mode, called so that its
function is the stage's own: s3 with the centre tap alone and the power, s4
with the whole taps and the power, s5 the magnitude, s6 the mel product
without contrast, s7 A itself.  Tolerance 1e-4 of each array's largest
value, the budget of ``tests/test_torch_spectral_kernel.py``.  s1 (the chunk
product) is held against the JAX package's chunk basis with its bf16 split
summed back, on the same chunks, to 1e-5 of the largest |C|; s0 exactly.
The CUDA kernel is held against these plain versions on the card by
``chip_smoke.py`` (phase 6).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops.pallas import spectral as JS
from acids_transforms_tpu_torch.ops.cuda import _build
from acids_transforms_tpu_torch.ops.cuda import spectral as pk
from acids_transforms_tpu_torch.ops.fft import taps_for_window
from acids_transforms_tpu_torch.ops.mel import square_mel_banks
from acids_transforms_tpu_torch.ops.windows import get_window
from acids_transforms_tpu_torch.tools import sweep_kernel_floor as sweep_tool
from test_torch_common import SR, make_audio, rel, t2n

ROOT = Path(__file__).resolve().parents[1]
OFFSET, SCALE = 0.05, 1.3
# the JAX call whose function each stage is: taps (all, or the centre tap),
# power, mel bank or none, contrast, affine
JAX_CALL = {
    "s3_combine": dict(centre=True, power=2.0, mel=False, contrast="none", affine=False),
    "s4_taps": dict(centre=False, power=2.0, mel=False, contrast="none", affine=False),
    "s5_mag": dict(centre=False, power=1.0, mel=False, contrast="none", affine=False),
    "s6_mel_banded": dict(centre=False, power=1.0, mel=True, contrast="none", affine=False),
    "s7_full": dict(centre=False, power=1.0, mel=True, contrast="log1p", affine=True),
}


@pytest.fixture(scope="module", params=[(1024, 256, "hann"), (512, 128, "hamming")],
                ids=["1024-256-hann", "512-128-hamming"])
def case(request):
    """Two clips of 0.5 s, A's rows for them and every plain stage."""
    n_fft, hop, wname = request.param
    x = make_audio(23, batch=2, n=SR // 2, channels=1)[:, 0]
    window = get_window(wname, n_fft)
    taps = taps_for_window(window)
    bank = torch.as_tensor(square_mel_banks(n_fft, SR)[0])
    tile_t = pk._kernel_tile(n_fft, hop, taps)
    rows, n_frames, _ = pk._prepare_rows(torch.as_tensor(x), n_fft, hop, True, tile_t)
    args = (n_fft, hop, n_frames, taps, bank, OFFSET, SCALE)
    stages = {s: pk.melspec_forward_stage_reference(rows, s, *args) for s in pk.STAGES}
    return dict(x=x, n_fft=n_fft, hop=hop, window=window, taps=taps, bank=bank, tile_t=tile_t,
                rows=rows, n_frames=n_frames, args=args, stages=stages)


@pytest.mark.parametrize("stage", list(JAX_CALL))
def test_plain_stage_vs_pallas_kernel(case, stage):
    c = JAX_CALL[stage]
    y = JS.fused_melspec(
        jnp.asarray(case["x"]), case["n_fft"], case["hop"], jnp.asarray(t2n(case["window"])),
        mel_bank=jnp.asarray(t2n(case["bank"])) if c["mel"] else None,
        offset=OFFSET if c["affine"] else 0.0, scale=SCALE if c["affine"] else 1.0,
        contrast=c["contrast"], interpret=True,
        taps=case["taps"][:1] if c["centre"] else case["taps"], power=c["power"],
    )
    got = t2n(case["stages"][stage])
    assert got.shape == y.shape
    assert rel(got, np.asarray(y)) <= 1e-4


def test_plain_chunk_product_vs_jax_tables(case):
    """s1: Cre + Cim of each frame's first chunk, against the chunks times the
    JAX package's chunk basis (its ``[hi; lo]`` bf16 split summed back) and its
    nyquist column, which that package takes apart as sum x (-1)^n."""
    n_fft, hop, n_frames = case["n_fft"], case["hop"], case["n_frames"]
    F, Fp, CC, CS, _, _ = JS._factored_weights(n_fft, hop)

    def summed(m):
        hi, lo = JS._split_bf16(m)
        return np.asarray(hi.astype(jnp.float32), np.float64) + np.asarray(lo.astype(jnp.float32), np.float64)

    r = t2n(case["rows"]).astype(np.float64)[:, :n_frames]
    Cre, Cim = r @ summed(CC), r @ summed(CS)
    if Fp == F - 1:
        nyq = r @ ((-1.0) ** np.arange(hop))
        Cre = np.concatenate([Cre, nyq[..., None]], -1)
        Cim = np.concatenate([Cim, np.zeros_like(nyq)[..., None]], -1)
    else:
        Cre, Cim = Cre[..., :F], Cim[..., :F]
    got = t2n(case["stages"]["s1_dots"])
    assert got.shape == Cre.shape
    assert np.abs(got - (Cre + Cim)).max() <= 1e-5 * np.abs(Cre + 1j * Cim).max()


def test_dense_mel_equals_banded(case):
    assert rel(t2n(case["stages"]["s8_mel_dense"]), t2n(case["stages"]["s6_mel_banded"])) <= 1e-6


def test_copy_stage_is_each_blocks_first_sample(case):
    """s0: zeros plus the first sample of the block a frame lies in, read from
    the JAX package's own rows of the same padded signal."""
    tile_t = case["tile_t"]
    x_rows = np.asarray(JS._prepare_rows(jnp.asarray(case["x"]), case["n_fft"], case["hop"], True,
                                         tile_t)[0])
    first = x_rows[:, (np.arange(case["n_frames"]) // tile_t) * tile_t, 0]
    want = np.broadcast_to(first[..., None], case["stages"]["s0_copy"].shape)
    assert np.array_equal(t2n(case["stages"]["s0_copy"]), want)


def test_wrapper_on_a_cpu_tensor_runs_the_plain_version(case):
    before = dict(pk.launches)
    for stage in ("s1_dots", "s7_full"):
        y = pk.melspec_forward_stage(case["rows"], stage, *case["args"])
        assert torch.equal(y, case["stages"][stage])
    assert pk.launches == before
    # s7 is A on the factored front end: the plain stage equals A's plain
    # version on that front end, on the same audio (the public call takes the
    # FFT route at these powers of two; test_s7_is_the_public_call_where_a_is_factored)
    re, im = pk._factored_spectrum(torch.as_tensor(case["x"]), case["n_fft"], case["hop"], True, case["taps"])
    a = pk._melspec_epilogue(re, im, case["bank"], OFFSET, SCALE, "log1p", 1.0, torch.float32)
    assert torch.equal(case["stages"]["s7_full"], a)


def test_s7_is_the_public_call_where_a_is_factored():
    """At 1408/352 (2^7 11: n_fft neither a power of two nor 7-smooth) A
    keeps the factored front end: the plain ``s7_full`` is the public call,
    bit for bit, as ``chip_smoke.py`` holds kernel T against A there."""
    n_fft, hop = 1408, 352
    x = torch.as_tensor(make_audio(24, batch=2, n=SR // 4, channels=1)[:, 0])
    taps = taps_for_window(get_window("hann", n_fft))
    bank = torch.as_tensor(square_mel_banks(n_fft, SR)[0])
    assert pk._kernel_plan(n_fft, hop, taps)[1] == 0
    rows, n_frames, _ = pk._prepare_rows(x, n_fft, hop, True, pk._kernel_tile(n_fft, hop, taps))
    s7 = pk.melspec_forward_stage(rows, "s7_full", n_fft, hop, n_frames, taps, bank, OFFSET, SCALE)
    a = pk.fused_melspec(x, n_fft, hop, bank, OFFSET, SCALE, "log1p", taps=taps)
    assert torch.equal(s7, a)


def test_wrapper_refuses_what_kernel_t_does_not_take(case):
    rows, args = case["rows"], case["args"]
    with pytest.raises(ValueError, match="stage must be one of"):
        pk.melspec_forward_stage(rows, "s2_dots3", *args)
    with pytest.raises(ValueError, match="rows must be"):
        pk.melspec_forward_stage(rows[:, :-1], "s5_mag", *args)
    with pytest.raises(ValueError, match="cosine-sum taps"):
        pk.melspec_forward_stage(rows, "s5_mag", *args[:3], None, *args[4:])


def test_sweep_has_no_cpu_mode():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the sweep would run its full course")
    res = subprocess.run([sys.executable, "-m", "acids_transforms_tpu_torch.tools.sweep_kernel_floor"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA device" in res.stderr and "s0_copy" not in res.stdout


def test_sweep_signal_and_stage_order():
    a, b = sweep_tool.additive_signal(4410, 0), sweep_tool.additive_signal(4410, 1)
    assert a.dtype == np.float32 and a.shape == (4410,)
    assert np.isclose(np.abs(a).max(), 0.5) and np.array_equal(a, sweep_tool.additive_signal(4410, 0))
    assert not np.array_equal(a, b)
    # every timed stage but the first builds on one timed before it
    order = list(pk.STAGES)
    assert set(sweep_tool.BASE) == set(order[1:])
    assert all(order.index(base) < order.index(s) for s, base in sweep_tool.BASE.items())
    assert "fp32" in sweep_tool.S2_ABSENT and "s2_dots3" not in pk.STAGES


def test_kernel_resources_reads_ptxas_output():
    log = (
        "ptxas info    : Compiling entry function '_ZN3att20melspec_stage_kernelILi3EEEvPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN3att20melspec_stage_kernelILi3EEEvPKf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 170 registers, used 1 barriers, 456 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN3att10other' for 'sm_90a'\n"
        "ptxas info    : Used 32 registers\n"
    )
    res = _build.kernel_resources(log)
    assert res["_ZN3att20melspec_stage_kernelILi3EEEvPKf"] == dict(registers=170, spill_stores=8, spill_loads=4)
    assert res["_ZN3att10other"] == dict(registers=32)
