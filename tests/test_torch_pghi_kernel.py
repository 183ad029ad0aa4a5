"""The plain PyTorch versions of kernel K (``ops/cuda/pghi_kernel.py``: PGHI
phases, bidirectional phases, synthesis, whole inversion) against the JAX
package's Pallas kernel run in interpret mode, as its own tests run it
off-TPU, with the silent-bin phases pinned on both sides.

On the CPU the port's wrappers run exactly these plain versions; the CUDA
kernels are held against them on the card by ``chip_smoke.py``.  Tolerances:
audio 1e-4 max-abs over max-abs (float32 products in another order), phases
1e-3 absolute (unwrapped float32 sums; the test content keeps them small, see
``test_torch_common.tones``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import pghi_kernel as JK
from acids_transforms_tpu_torch.ops import pghi as PP
from acids_transforms_tpu_torch.ops import windows as pwin
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PK
from test_torch_common import jax_angles, rel, t2n, tones


def setup(n_fft, hop, x, seed=3):
    dgt = JT.DGT(n_fft=n_fft, hop_length=hop)
    mag = np.array(jnp.abs(dgt.forward(jnp.asarray(x))))
    ang = jax_angles(mag.shape, seed)
    return dgt, mag, ang, torch.as_tensor(np.array(dgt.inv_window)), pwin.dgt_gamma(n_fft)


def test_invert_fused_audio_vs_pallas_kernel():
    x = tones(30000, [(220, 440, 880), (220, 440, 880)])
    x[1] *= 0.5
    dgt, mag, ang, w, g = setup(1024, 256, x, seed=0)
    ref = np.asarray(JK.pghi_invert_fused(jnp.asarray(mag), dgt.gamma, 1024, 256, dgt.inv_window,
                                          tolerance=1e-2, angles=jnp.asarray(ang)))
    got = PK.pghi_invert_fused(torch.as_tensor(mag), g, 1024, 256, w, 1e-2, angles=torch.as_tensor(ang))
    assert tuple(got.shape) == ref.shape and rel(t2n(got), ref) <= 1e-4
    # `length` pads or trims like the JAX kernel's epilogue
    for length in (20000, 31000):
        rl = np.asarray(JK.pghi_invert_fused(jnp.asarray(mag), dgt.gamma, 1024, 256, dgt.inv_window,
                                             tolerance=1e-2, angles=jnp.asarray(ang), length=length))
        gl = PK.pghi_invert_fused(torch.as_tensor(mag), g, 1024, 256, w, 1e-2,
                                  angles=torch.as_tensor(ang), length=length)
        natural = (mag.shape[1] - 1) * 256
        assert gl.shape == (2, length) and rel(t2n(gl)[:, :natural], rl[:, :natural]) <= 1e-4
        # past the centre trim lie the last n_fft / 2 samples of the overlap-add,
        # divided by an envelope that falls to w[-1]^2 = 1e-4: rounding is
        # amplified there in both packages alike (hence 1e-3), then zeros
        assert rel(t2n(gl), rl) <= 1e-3 and not t2n(gl)[:, natural + 512:].any()


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (768, 192)])
def test_phases_fused_vs_pallas_kernel_and_scan(n_fft, hop):
    dgt, mag, ang, _, g = setup(n_fft, hop, tones(20000, [(330,), (550,)]), seed=1)
    ref = np.asarray(JK.pghi_phases_fused(jnp.asarray(mag), dgt.gamma, n_fft, hop, tolerance=1e-2,
                                          angles=jnp.asarray(ang)))
    got = PK.pghi_phases_fused(torch.as_tensor(mag), g, n_fft, hop, 1e-2, angles=torch.as_tensor(ang))
    assert tuple(got.shape) == ref.shape and np.abs(t2n(got) - ref).max() <= 1e-3
    scan = PP.pghi_scan(torch.as_tensor(mag), g, n_fft, hop, 1e-2, time_stencil="central",
                        angles=torch.as_tensor(ang))
    assert (got - scan).abs().max() <= 1e-3      # the kernel's order of additions vs the scan's
    # the same recurrence in float64 (same masks): what float32 costs here
    f64 = PK.pghi_phases_fused_reference(torch.as_tensor(mag), g, n_fft, hop, 1e-2,
                                         angles=torch.as_tensor(ang), dtype=torch.float64)
    assert f64.dtype == torch.float64 and (got.double() - f64).abs().max() <= 1e-3


def test_synthesize_fused_vs_pallas_kernel():
    dgt, mag, ang, w, _ = setup(512, 64, tones(9000, [(220,), (440, 660)]))
    ref = np.asarray(JK.pghi_synthesize_fused(jnp.asarray(mag), jnp.asarray(ang), 512, 64, dgt.inv_window))
    got = PK.pghi_synthesize_fused(torch.as_tensor(mag), torch.as_tensor(ang), 512, 64, w)
    assert tuple(got.shape) == ref.shape and rel(t2n(got), ref) <= 1e-4
    # and it is the least-squares ISTFT of mag * e^{i phases}
    from acids_transforms_tpu_torch.ops.fft import istft

    direct = istft(torch.polar(torch.as_tensor(mag), torch.as_tensor(ang)), 512, 64, w)
    assert rel(t2n(got), t2n(direct)) <= 1e-5


def test_phases_bidir_vs_pallas_kernel():
    dgt, mag, ang, w, g = setup(512, 128, tones(12000, [(220, 440), (330,), (262, 523)]), seed=5)
    ref = np.asarray(JK.pghi_phases_bidir(jnp.asarray(mag), dgt.gamma, 512, 128, tolerance=1e-2,
                                          angles=jnp.asarray(ang)))
    got = PK.pghi_phases_bidir(torch.as_tensor(mag), g, 512, 128, 1e-2, angles=torch.as_tensor(ang))
    assert tuple(got.shape) == ref.shape and np.abs(t2n(got) - ref).max() <= 1e-3
    causal = PK.pghi_phases_fused(torch.as_tensor(mag), g, 512, 128, 1e-2, angles=torch.as_tensor(ang))
    mid = mag.shape[1] // 2
    assert not torch.allclose(got[:, :mid], causal[:, :mid], atol=1e-2)   # another integration order
    ra = np.asarray(JK.pghi_invert_bidir(jnp.asarray(mag), dgt.gamma, 512, 128, dgt.inv_window,
                                         tolerance=1e-2, angles=jnp.asarray(ang)))
    ga = PK.pghi_invert_bidir(torch.as_tensor(mag), g, 512, 128, w, 1e-2, angles=torch.as_tensor(ang))
    assert rel(t2n(ga), ra) <= 1e-4
    # below 4 frames the bidirectional entry is the causal one
    few = torch.as_tensor(mag[:, :3])
    assert torch.equal(PK.pghi_phases_bidir(few, g, 512, 128, angles=torch.as_tensor(ang[:, :3])),
                       PK.pghi_phases_fused(few, g, 512, 128, angles=torch.as_tensor(ang[:, :3])))


@pytest.mark.parametrize(
    "n_fft,hop,n,batch",
    [
        (512, 256, 6000, 1),     # overlap 2, tiny T, batch 1
        (512, 64, 9000, 2),      # overlap 8
        (768, 192, 9000, 2),     # hop neither a multiple nor a divisor of 128
        (1024, 256, 4000, 3),    # fewer frames than one synthesis tile
    ],
)
def test_invert_fused_edge_shapes_vs_pallas_kernel(n_fft, hop, n, batch):
    x = tones(n, [(220 * (b + 1),) for b in range(batch)])
    dgt, mag, ang, w, g = setup(n_fft, hop, x)
    ref = np.asarray(JK.pghi_invert_fused(jnp.asarray(mag), dgt.gamma, n_fft, hop, dgt.inv_window,
                                          tolerance=1e-2, angles=jnp.asarray(ang)))
    got = PK.pghi_invert_fused(torch.as_tensor(mag), g, n_fft, hop, w, 1e-2, angles=torch.as_tensor(ang))
    assert tuple(got.shape) == ref.shape and rel(t2n(got), ref) <= 1e-4
    lead = PK.pghi_invert_fused(torch.as_tensor(mag)[None], g, n_fft, hop, w, 1e-2,
                                angles=torch.as_tensor(ang)[None])
    assert lead.shape == (1,) + tuple(got.shape) and torch.equal(lead[0], got)   # leading batch dims


def test_silent_frames_and_silent_clip():
    """A frame without a significant bin is all angles; after it the next
    audible frame seeds at its maximum; an all-silent clip is all angles."""
    dgt, mag, ang, _, g = setup(512, 128, tones(9000, [(220, 440), (330,)]))
    mag[0, 20:24] = 0.0
    mag[1] = 0.0
    got = PK.pghi_phases_fused(torch.as_tensor(mag), g, 512, 128, 1e-2, angles=torch.as_tensor(ang))
    assert np.array_equal(t2n(got[0, 20:24]), ang[0, 20:24]) and np.array_equal(t2n(got[1]), ang[1])
    ref = np.asarray(JK.pghi_phases_fused(jnp.asarray(mag), dgt.gamma, 512, 128, tolerance=1e-2,
                                          angles=jnp.asarray(ang)))
    assert np.abs(t2n(got) - ref).max() <= 1e-3


@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_block_scan_is_the_segmented_scan(tiles):
    """The fill's segmented scan, shared by both recurrences
    (``pghi_kernel._fill_scan``: 4 bins a lane, Kogge-Stone over the lanes,
    the 128-bin tiles' carry), against a bin-by-bin loop over 128, 256 and
    512 bins, on integer-valued steps (sums exact in any order), both
    directions (the downward one runs up the flipped row, as
    ``fill_sources`` runs it)."""
    rng = np.random.default_rng(tiles)
    n = 128 * tiles
    anch = rng.random((2, n)) < 0.05
    val = rng.integers(-50, 50, (2, n)).astype(np.float32)
    for flip in (False, True):
        f, v = (anch[:, ::-1], val[:, ::-1]) if flip else (anch, val)
        got = PK._fill_scan(torch.as_tensor(f.copy()), torch.as_tensor(v.copy())).numpy()
        run = np.zeros((2,), np.float32)
        for k in range(n):
            run = np.where(f[:, k], v[:, k], run + v[:, k])
            assert np.array_equal(got[:, k], run)


def test_wide_bins_take_several_bins_per_thread():
    """n_fft 2048 (1025 bins, a plan block of 8 frames, a walk block of 5
    warps): same phases as the scan."""
    dgt, mag, ang, _, g = setup(2048, 512, tones(20000, [(220, 440)]))
    got = PK.pghi_phases_fused(torch.as_tensor(mag), g, 2048, 512, 1e-2, angles=torch.as_tensor(ang))
    scan = PP.pghi_scan(torch.as_tensor(mag), g, 2048, 512, 1e-2, time_stencil="central",
                        angles=torch.as_tensor(ang))
    assert (got - scan).abs().max() <= 1e-3


def test_gates_chains_and_shared_memory():
    assert PK.pghi_fused_available(1024, 256) and PK.pghi_fused_available(512, 64)
    assert PK.pghi_fused_available(768, 192) and PK.pghi_fused_available(640, 160)
    assert PK.pghi_fused_available(2048, 512) and PK.pghi_fused_available(4096, 1024)
    assert not PK.pghi_fused_available(1024, 160)      # hop does not divide n_fft
    assert not PK.pghi_fused_available(512, 512)       # overlap 1
    assert PK.pghi_phases_available(1026, 342) and not PK.pghi_fused_available(1026, 342)  # hop % 4
    assert not PK.pghi_phases_available(16384, 4096)   # 8193 bins: more than the recurrence takes
    picks = {(1024, 256): 40, (512, 64): 40, (2048, 512): 16, (4096, 1024): 8, (8192, 2048): None}
    for (n_fft, hop), rows in picks.items():
        assert PK._pick_rows(n_fft, hop) == rows
        if rows is not None:
            assert PK._synth_smem_bytes(rows, n_fft // hop, PK._k_padded(n_fft // 2 + 1)) <= PK.MAX_SMEM
    # causal: frame -1 is the zero frame, the last frame's stencil replicates the edge
    fp, fn, sgn = PK._orientation(5, False)
    assert fp == [-1, 0, 1, 2, 3] and fn == [1, 2, 3, 4, 4] and sgn == [1.0] * 5
    assert PK._walk_order(5, False) == [[(t, True) for t in range(5)]]
    # bidir: frames before T // 2 backward, chain 1 repeats the seed step unstored
    fp, fn, sgn = PK._orientation(7, True)
    assert fp == [1, 2, 3, 2, 3, 4, 5] and fn == [0, 0, 1, 4, 5, 6, 6] and sgn == [-1.0] * 3 + [1.0] * 4
    right, left = PK._walk_order(7, True)
    assert right == [(3, True), (4, True), (5, True), (6, True)]
    assert left == [(3, False), (2, True), (1, True), (0, True)]
    with pytest.raises(ValueError, match="expected magnitudes"):
        PK.pghi_phases_fused(torch.zeros(2, 5, 100), 1.0, 512, 128)
    assert PK.launches == {"pghi_plan": 0, "pghi_phases": 0, "pghi_synthesize": 0}   # nothing launched on the CPU
