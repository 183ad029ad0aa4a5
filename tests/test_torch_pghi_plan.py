"""K's offline PGHI recurrence on its plan / walk schedule
(``ops/cuda/pghi_kernel.py``): the plan computes, for every frame of every
clip at once and from magnitudes alone, each bin's source bin and ``off =
ct[src] + seg`` (``fill_sources``, the fill shared with the streaming
recurrence); the walk then takes ``phi_t[k] = phi_{t-1}[src] + off`` frame by
frame.  The kernels ``csrc/pghi.cu:pghi_plan_kernel`` / ``pghi_walk_kernel``
repeat these plain versions' float32 operations in order.

Tolerances, and why:

* against the JAX package's Pallas kernel in interpret mode (causal and
  bidirectional, the silent-bin phases pinned on both sides): 1e-3 rad on
  the circle at the audible bins (the budget ``test_torch_pghi_kernel.py``
  holds the port to: float32 sums in another order), the silent bins' angles
  exactly;
* against the old schedule (``test_torch_common.old_k_phases``: ``phi +
  ct`` at the anchors, two segmented scans of affine maps a frame) in
  float64: the same anchors and sources, so the float64 runs agree to 1e-12
  of the largest phase; the new float32 run is no further from that float64
  run than 1.5 times the old schedule's float32 run, or 4 ulp of the
  largest phase where both are within a few ulp (measured: 0.4-1.0 times
  the old schedule's distance on these inputs, one case 1.5 at 33 bins);
* the plan alone on integer-valued steps: segment sums exact.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import pghi_kernel as JK
from acids_transforms_tpu_torch.ops import windows as pwin
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PK
from acids_transforms_tpu_torch.ops.pghi import EPS
from test_torch_common import jax_angles, old_k_phases, t2n, tones

torch.set_num_threads(1)


def circle(a, b):
    d = np.angle(np.exp(1j * (np.float64(a) - np.float64(b))))
    return float(np.abs(d).max()) if d.size else 0.0


def dgt_mags(n_fft, hop, n=12000, seed=1):
    dgt = JT.DGT(n_fft=n_fft, hop_length=hop)
    mag = np.array(jnp.abs(dgt.forward(jnp.asarray(tones(n, [(330,), (550, 880)])))))
    return dgt, mag, jax_angles(mag.shape, seed)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (768, 192), (2048, 512), (600, 150)])
def test_plain_versions_vs_pallas_kernel(n_fft, hop):
    """Causal and bidirectional phases against the JAX kernel at 513, 385,
    1025 and 301 bins: audible bins within 1e-3 rad, silent bins their
    angles; and against the old schedule's float64 run (module notes)."""
    dgt, mag, ang = dgt_mags(n_fft, hop)
    g = pwin.dgt_gamma(n_fft)
    m, a = torch.as_tensor(mag), torch.as_tensor(ang)
    loud = mag > 1e-2 * mag.max(axis=(1, 2), keepdims=True)
    assert 0.01 < loud.mean() < 0.9
    for bidir in (False, True):
        jfn = JK.pghi_phases_bidir if bidir else JK.pghi_phases_fused
        ref = np.asarray(jfn(jnp.asarray(mag), dgt.gamma, n_fft, hop, tolerance=1e-2, angles=jnp.asarray(ang)))
        plain = PK.pghi_phases_bidir_reference if bidir else PK.pghi_phases_fused_reference
        got = plain(m, g, n_fft, hop, 1e-2, angles=a)
        assert tuple(got.shape) == ref.shape
        assert circle(t2n(got)[loud], ref[loud]) <= 1e-3
        assert np.array_equal(t2n(got)[~loud], ang[~loud])
        # the entry points run the plain version on a CPU tensor
        entry = PK.pghi_phases_bidir if bidir else PK.pghi_phases_fused
        assert torch.equal(entry(m, g, n_fft, hop, 1e-2, angles=a), got)
        old64 = old_k_phases(m, a, g, n_fft, hop, 1e-2, bidir, torch.float64)
        old32 = old_k_phases(m, a, g, n_fft, hop, 1e-2, bidir, torch.float32)
        new64 = plain(m, g, n_fft, hop, 1e-2, angles=a, dtype=torch.float64)
        scale = old64.abs().max()
        assert (new64 - old64).abs().max() <= 1e-12 * scale
        e_new, e_old = (got.double() - old64).abs().max(), (old32.double() - old64).abs().max()
        assert e_new <= max(1.5 * e_old, 4 * scale * 2.0 ** -23), (float(e_new), float(e_old))


def drifting(B, T, n_bins, seed):
    """Ridges drifting in frequency over low noise."""
    rng = np.random.default_rng(seed)
    t, k = np.arange(T)[:, None], np.arange(n_bins)[None, :]
    m = 1e-3 * rng.random((B, T, n_bins))
    for b in range(B):
        for _ in range(5):
            c, w, amp = rng.uniform(2, n_bins - 3), rng.uniform(1, 4), rng.uniform(0.2, 1)
            m[b] += amp * np.exp(-0.5 * ((k - c - 0.1 * t) / w) ** 2)
    return torch.as_tensor(m.astype(np.float32))


@pytest.mark.parametrize("n_bins", [33, 257, 1000])
def test_fill_sources_integer_steps_and_the_tie_rule(n_bins):
    """The shared fill on integer-valued steps (even ``fs``: every trapezoid
    step an integer, so every sum is exact in any order) against a bin-by-bin
    loop: each audible bin's source is itself at an anchor, else the nearest
    anchor (below on a tie), and its segment sum the steps from there; a
    frame without a peak anchor takes the onset rule; silent bins keep the
    constant with source -1."""
    rng = np.random.default_rng(n_bins)
    B, T = 2, 6
    mag = rng.random((B, T, n_bins)).astype(np.float32)
    sig = mag > 0.2
    peak = sig & (rng.random((B, T, n_bins)) < 0.04)
    peak[0, 0] = False                                   # the onset rule
    mag[0, 0, n_bins // 2] = 2.0
    sig[0, 0, n_bins // 2] = True
    peak[1, 1] = False                                   # no anchor at all: the maximum is silent
    sig[1, 1, int(mag[1, 1].argmax())] = False
    if n_bins > 12:                                      # a tie: anchors 2 apart around an audible bin
        peak[1, 2] = False
        peak[1, 2, [3, 5]] = True
        sig[1, 2, 3:6] = True
    fs = 2.0 * rng.integers(-20, 20, (B, T, n_bins)).astype(np.float32)
    const = rng.random((B, T, n_bins)).astype(np.float32)
    tt = torch.as_tensor
    src, seg = PK.fill_sources(tt(mag), tt(peak), tt(sig), tt(fs), tt(const))
    src, seg = src.numpy(), seg.numpy()
    step_up = np.concatenate([np.zeros((B, T, 1)), (fs[..., 1:] + fs[..., :-1]) / 2], axis=-1)
    for b in range(B):
        for t in range(T):
            anch = peak[b, t].copy()
            if not anch.any():
                anch = sig[b, t] & (mag[b, t] == mag[b, t].max())
            at = np.flatnonzero(anch)
            for k in range(n_bins):
                if not sig[b, t, k]:
                    assert src[b, t, k] == -1 and seg[b, t, k] == const[b, t, k]
                elif not len(at):
                    assert src[b, t, k] == -1 and seg[b, t, k] == 0.0
                elif anch[k]:
                    assert src[b, t, k] == k and seg[b, t, k] == 0.0 and np.signbit(seg[b, t, k])
                else:
                    d = np.abs(at - k)
                    s = at[np.flatnonzero(d == d.min())[0]]      # the first of a tie is the one below
                    assert src[b, t, k] == s
                    want = step_up[b, t, s + 1:k + 1].sum() if s < k else -step_up[b, t, k + 1:s + 1].sum()
                    assert seg[b, t, k] == want
    if n_bins > 12:
        assert src[1, 2, 4] == 3 and (src[1, 1] == -1).all() and src[0, 0, n_bins // 2] == n_bins // 2


def test_plan_orientation_and_the_shared_seed_row():
    """Under ``bidir`` the plan takes frames t >= T // 2 as the causal plan
    does (bit for bit) and frames before mid backward: at an anchor, ``off``
    is ``ct``, ``-(ts(Y[t + 1]) + ts(Y[t])) / 2`` there and ``+(ts(Y[t - 1]) +
    ts(Y[t])) / 2`` forward (checked in float64).  Both chains read the one
    plan row at mid: the phases at mid are that row's ``off``, and frame mid
    - 1 gathers from them.  The padded plan the kernels take walks to the
    entry points' phases."""
    n_bins, T, n_fft, hop = 129, 11, 256, 64
    g = 0.25645 * n_fft * n_fft
    m = drifting(2, T, n_bins, 3)
    a = torch.as_tensor(np.random.default_rng(4).uniform(0, 2 * np.pi, m.shape).astype(np.float32))
    s_c, o_c = PK.pghi_plan(m, g, n_fft, hop, 1e-2, False, angles=a)
    s_b, o_b = PK.pghi_plan(m, g, n_fft, hop, 1e-2, True, angles=a)
    fp = PK._plan_row(n_bins)
    assert s_b.dtype == torch.int16 and tuple(s_b.shape) == (2, T, fp) and o_b.shape == s_b.shape
    assert (s_b[..., n_bins:] == -1).all() and (o_b[..., n_bins:] == 0).all()
    mid = T // 2
    assert torch.equal(s_b[:, mid:], s_c[:, mid:]) and torch.equal(o_b[:, mid:], o_c[:, mid:])
    assert not torch.equal(o_b[:, :mid], o_c[:, :mid])
    fmul, inv_fmul, carrier = PK._constants(g, n_fft, hop)
    Y = torch.log(torch.clamp_min(m.double(), EPS))
    k = torch.arange(n_bins, dtype=torch.float64)
    ts = lambda y: ((torch.cat([y[..., 1:], y[..., -1:]], -1) - torch.cat([y[..., :1], y[..., :-1]], -1)) * 0.5
                    * inv_fmul + carrier * k)
    n_anchors = 0
    for t in range(T):
        ct = (-0.5 * (ts(Y[:, t + 1]) + ts(Y[:, t])) if t < mid else
              0.5 * (ts(Y[:, t - 1]) + ts(Y[:, t])))
        at = s_b[:, t, :n_bins].long() == k.long()
        n_anchors += int(at.sum())
        assert torch.allclose(o_b[:, t, :n_bins][at].double(), ct[at], rtol=1e-6, atol=1e-4)
    assert n_anchors > 2 * T
    ph = PK.pghi_walk(s_b, o_b, n_bins, True)
    assert torch.equal(ph, PK.pghi_phases_bidir(m, g, n_fft, hop, 1e-2, angles=a))
    assert torch.equal(ph[:, mid], o_b[:, mid, :n_bins])
    s1 = s_b[:, mid - 1, :n_bins].long()
    prev = torch.where(s1 >= 0, ph[:, mid].gather(1, s1.clamp_min(0)) + o_b[:, mid - 1, :n_bins],
                       o_b[:, mid - 1, :n_bins])
    assert torch.equal(ph[:, mid - 1], prev)
    assert torch.equal(PK.pghi_walk(s_c, o_c, n_bins), PK.pghi_phases_fused(m, g, n_fft, hop, 1e-2, angles=a))


def test_onset_frame_silent_frame_and_silent_clip():
    """After a silent frame the next audible frame has no anchor by the peak
    rule (its previous frame is below the threshold), so its audible bins
    equal to its maximum anchor it and every other audible bin fills from
    the nearest of them; a silent frame and a silent clip are their angles,
    bit for bit, in the plan and in the phases."""
    n_bins, T, n_fft, hop = 65, 9, 128, 32
    g = 0.25645 * n_fft * n_fft
    m = drifting(2, T, n_bins, 8)
    m[0, 4] = 0.0
    m[1] = 0.0
    a = torch.as_tensor(np.random.default_rng(9).uniform(0, 2 * np.pi, m.shape).astype(np.float32))
    src, off = PK.pghi_plan(m, g, n_fft, hop, 1e-2, False, angles=a)
    src, off = src[..., :n_bins].long(), off[..., :n_bins]
    ph = PK.pghi_phases_fused(m, g, n_fft, hop, 1e-2, angles=a)
    assert torch.equal(ph[0, 4], a[0, 4]) and torch.equal(ph[1], a[1]) and (src[1] == -1).all()
    assert torch.equal(off[1], a[1]) and (src[0, 4] == -1).all()
    thr = torch.clamp_min(1e-2 * m[0].max(), EPS)
    loud = m[0, 5] > thr
    anchors = (loud & (m[0, 5] == m[0, 5].max())).nonzero()[:, 0]
    assert len(anchors) >= 1 and torch.equal(src[0, 5, anchors], anchors)
    audible = loud.nonzero()[:, 0]
    near = anchors[(audible[:, None] - anchors[None, :]).abs().argmin(dim=1)]
    assert torch.equal(src[0, 5, audible], near)
    assert torch.equal(off[0, 5][~loud], a[0, 5][~loud])


def test_the_plan_is_a_pure_function_of_the_bins_and_the_frames():
    """For every number of bins up to 4096 and clips of 1 to 690 frames the
    plan fits shared memory and the kernels' limits: a plan tile of the
    widest of 4 / 2 / 1 frames up to T that fits, a walk block of at
    most 16 chain warps, a warp for each 128 bins of the plan's rows and at
    most two groups of 4 bins a thread, 4 ring slots of 4 plan rows where
    they fit, else 2; the same arguments give the same plan; more bins
    or no frame raise.  The caps are the limits the entries refuse beyond."""
    cu = (pathlib.Path(PK.__file__).parents[2] / "csrc" / "pghi.cu").read_text()
    assert "kPlanTile = 4;" in cu and "kWalkQuads = 2;" in cu and "kWalkWarps = 16;" in cu
    assert "slots != 2 && slots != 4" in cu and "tile > kPlanTile" in cu and "F > 4096" in cu
    assert "kWalkGroup = 4;" in cu and PK.PLAN_TILES[0] == 4
    assert PK.WALK_SLOTS == (4, 2) and PK._WALK_QUADS == 2 and PK.MAX_BINS == 4096
    for n_bins in range(2, PK.MAX_BINS + 1):
        fp = PK._plan_row(n_bins)
        assert fp % 8 == 0 and n_bins <= fp < n_bins + 8
        for T in (1, 2, 3, 5, 8, 690):
            plan = PK._phases_plan(n_bins, T)
            tile, warps, slots = plan
            assert plan == PK._phases_plan(n_bins, T)
            assert tile in PK.PLAN_TILES and tile <= T and PK._plan_smem_bytes(n_bins, tile) <= PK.MAX_SMEM
            wider = [t for t in PK.PLAN_TILES if tile < t <= T]
            assert all(PK._plan_smem_bytes(n_bins, t) > PK.MAX_SMEM for t in wider)
            assert warps == min(16, -(-fp // 128)) and 32 * warps * 4 * 2 >= fp
            assert PK._walk_smem_bytes(n_bins, slots) <= PK.MAX_SMEM
            assert slots == 4 or PK._walk_smem_bytes(n_bins, 4) > PK.MAX_SMEM
    assert PK._phases_plan(513, 690) == (4, 5, 4) and PK._phases_plan(4096, 690) == (2, 16, 2)
    assert PK._phases_plan(2049, 690) == (4, 16, 4) and PK._phases_plan(513, 3) == (2, 5, 4)
    for bad in ((4097, 10), (1, 10), (513, 0)):
        with pytest.raises(ValueError):
            PK._phases_plan(*bad)
    assert PK.pghi_phases_available(8190, 4095) and not PK.pghi_phases_available(8194, 4097)
