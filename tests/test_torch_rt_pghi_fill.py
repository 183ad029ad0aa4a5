"""The RT-PGHI recurrence with its fill off the serial chain
(``ops/cuda/stream_step.py``: ``rt_fill_plan`` computes every frame's
threshold, anchors, time steps ``ct``, and for every bin the source of its
value and the segment sum of the frequency steps from it, from magnitudes
alone; ``rt_pghi_phases_reference`` then walks the frames, ``phi_t[k] =
(phi_{t-1}[src] + ct[src]) + seg[k]``), the schedule that the kernel
``csrc/pghi.cu:rt_pghi_phases_kernel`` repeats operation by operation.

Tolerances, and why:

* the plain sessions against the JAX Pallas kernels in interpret mode
  (the RT-PGHI roundtrip N fresh, the ``pghi_gl`` roundtrip O seeded): within
  1e-3 of the largest value, the bound ``test_torch_stream_pghi.py`` and
  ``test_torch_stream_pghi_gl.py`` hold them to (the TPU products are
  bf16x4, and the JAX kernel carries the phase unwrapped where the port
  re-wraps it per chunk); at 768/192 (385 bins), where the JAX ``pghi_gl``
  kernel takes no chunk, the seeded recurrence against the JAX ``pghi_scan``
  with the carry: audible bins within 1e-3 rad on the circle;
* against the schedule the kernel had before (two segmented scans of affine
  maps a frame, ``test_torch_common.old_fill_frame``, the schedule K's
  kernel had until it took the plan too) run in float64 on the same
  float32 ``ct`` and frequency steps: the anchors and every bin's source are
  identical; the phases differ only by the float32 additions of the fill and
  the re-wrap, so they are held within ``T_c`` x 2 ulp of the largest phase
  of the chunk (measured: at most ``T_c`` x 0.55 ulp; the old schedule in
  float32 came to ``T_c`` x 0.06-0.44 ulp on the same inputs, this one to
  0.78-1.17 times its root mean square error);
* frames without an anchor: a frame after silence takes the onset rule
  (its audible bins equal to the frame's maximum are the anchors, every
  other audible bin fills from them); an all-silent chunk is its angles,
  bit for bit.
"""
import itertools
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import stream_step as JK
from acids_transforms_tpu.ops.pghi import pghi_scan as j_pghi_scan
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as KK
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from acids_transforms_tpu_torch.ops.cuda.frames_fft import MAX_SMEM
from acids_transforms_tpu_torch.ops.pghi import EPS
from test_torch_common import (make_audio, old_bins_per_thread, old_block_scan, old_fill_frame, old_k_phases, rel,
                               t2n, tones)

torch.set_num_threads(1)
SHAPES = [(1024, 256), (768, 192)]        # 513 bins, and 385 (no power of two plus one)


def circle(a, b):
    d = np.angle(np.exp(1j * (np.float64(a) - np.float64(b))))
    return float(np.abs(d).max()) if d.size else 0.0


def padded_bins(n_bins):
    return -(-n_bins // 128) * 128


def session_angles(key, n_chunks, rows, n_bins):
    return np.array(JK._session_angles(key, n_chunks, rows, n_bins, padded_bins(n_bins), (2,)))[..., :n_bins]


@pytest.mark.parametrize("t_c", [8, 16])
@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_fresh_session_plain_vs_pallas(n_fft, hop, t_c):
    """The RT-PGHI roundtrip N (magnitude encode, the recurrence's plain
    version, P's synthesis) against the JAX kernel in interpret mode, the
    draws pinned: two sessions of two chunks and a ragged tail."""
    chunk, n_bins = t_c * hop, n_fft // 2 + 1
    x = make_audio(11, batch=2, n=2 * chunk + 300)[:, 0]
    key = jax.random.PRNGKey(13)
    ang = session_angles(key, 3, t_c, n_bins)
    jc = JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, inversion_mode="pghi")
    pc = PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(
        n_fft=n_fft, hop_length=hop, inversion_mode="pghi", device="cpu")
    y_p = PK.make_fused_pghi_roundtrip(pc, chunk, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    y_j = JK.make_fused_pghi_roundtrip(jc, chunk, key=key, interpret=True)(jnp.asarray(x))
    assert y_p.shape == y_j.shape == (2, 3 * chunk)
    assert rel(t2n(y_p), np.array(y_j)) <= 1e-3


@pytest.mark.parametrize("t_c,la", [(8, 2), (16, 0)])
def test_seeded_session_plain_vs_pallas(t_c, la):
    """The seeded one-chunk recurrence inside O (one projection a chunk, so
    that the seed shows), against the JAX ``pghi_gl`` kernel in interpret
    mode at 513 bins: chunks of 8 frames and a lookahead of 2 (10 frames a
    fill), and of 16."""
    n_fft, hop = 1024, 256
    chunk, n_bins = t_c * hop, n_fft // 2 + 1
    x = make_audio(11, batch=2, n=2 * chunk + 300)[:, 0]
    key = jax.random.PRNGKey(13)
    ang = session_angles(key, 3, t_c + la, n_bins)
    kw = dict(n_fft=n_fft, hop_length=hop, inversion_mode="pghi_gl", gl_iterations=1, lookahead_frames=la)
    jc = JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(**kw)
    pc = PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(device="cpu", **kw)
    y_p = PK.make_fused_pghi_gl_roundtrip(pc, chunk, angles=torch.as_tensor(ang))(torch.as_tensor(x))
    y_j = JK.make_fused_pghi_gl_roundtrip(jc, chunk, key=key, interpret=True)(jnp.asarray(x))
    assert y_p.shape == y_j.shape == (2, 3 * chunk)
    assert rel(t2n(y_p), np.array(y_j)) <= 1e-3


def test_seeded_recurrence_at_385_bins_matches_jax_pghi_scan():
    """The seeded one-chunk recurrence at 768/192 against the JAX
    ``pghi_scan`` with the carry (backward stencil, one threshold over the
    chunk): audible bins on the circle within 1e-3 rad, silent bins the
    draws."""
    n_fft, hop, t_c = 768, 192, 16
    n_bins = n_fft // 2 + 1
    rt = PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu")
    x = torch.as_tensor(tones(4 * t_c * hop, [(220, 440, 880), (330, 660)]))
    spec = torch.stft(x, n_fft, hop, window=rt.window, return_complex=True).transpose(-2, -1)
    mags = t2n(spec.abs())
    prev, m = mags[:, t_c - 2: t_c], mags[:, t_c: 2 * t_c + 2]
    prev_ph = np.random.default_rng(3).uniform(-np.pi, np.pi, (2, n_bins)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    ref = np.array(j_pghi_scan(jnp.asarray(m), rt.gamma, n_fft, hop, tolerance=rt.tolerance,
                               prev_mag=jnp.asarray(prev), prev_phase=jnp.asarray(prev_ph), key=key,
                               time_stencil="backward"))
    a = torch.as_tensor(np.array(2.0 * jnp.pi * jax.random.uniform(key, m.shape)))
    got = PK.rt_pghi_phases_reference(torch.as_tensor(m), a, rt.gamma, n_fft, hop, rt.tolerance, m.shape[1],
                                      prev_mag=torch.as_tensor(prev), prev_phase=torch.as_tensor(prev_ph))
    loud = m > rt.tolerance * m.max()
    assert loud.mean() > 0.02
    assert circle(t2n(got)[loud], ref[loud]) <= 1e-3
    assert np.array_equal(t2n(got)[~loud], t2n(a)[~loud])


# ------------------------------------------------ the schedule before
def old_schedule(mag, angles, gamma, n_fft, hop, tolerance, T_c, prev_mag=None, prev_phase=None,
                 dtype=torch.float64):
    """The recurrence on the schedule the kernel had before: per frame ``phi
    + ct`` at the anchors, then K's two-sided segmented fill of affine maps
    (``test_torch_common.old_fill_frame``), in ``dtype`` on the float32 ``ct`` and
    frequency steps (so that only the fill's additions differ).  Returns the
    phases and, per bin, the anchor it fills from (by the scans' distance
    channels; -1 where the bin is silent or its frame has no anchor)."""
    B, T, n_bins = mag.shape
    src_new, ct, _ = PK.rt_fill_plan(mag, angles, gamma, n_fft, hop, tolerance, T_c, prev_mag)
    fmul, _, _ = KK._constants(gamma, n_fft, hop)
    prev = mag.new_zeros((B, 2, n_bins)) if prev_mag is None else prev_mag
    mz = torch.cat([prev, mag], dim=1)
    Yz = torch.log(torch.clamp_min(mz, EPS))
    Y, Y1, Y2 = Yz[:, 2:], Yz[:, 1:-1], Yz[:, :-2]
    fs = (-fmul) * (((3.0 * Y - 4.0 * Y1) + Y2) * 0.5) + math.pi
    trap = (fs[..., 1:] + fs[..., :-1]) * 0.5
    zero = torch.zeros_like(fs[..., :1])
    sup, sdn = torch.cat([zero, trap], dim=-1), torch.cat([-trap, zero], dim=-1)
    mx = mag.reshape(B, T // T_c, T_c * n_bins).amax(dim=-1)
    thr = torch.clamp_min(tolerance * mx, EPS).repeat_interleave(T_c, dim=1)[..., None]
    sig = mag > thr
    mpad = torch.nn.functional.pad(mag, (1, 1), value=-1.0)
    anch = sig & (mz[:, 1:-1] > thr) & (mag >= mpad[..., :-2]) & (mag >= mpad[..., 2:])
    anch = anch | (~anch.any(dim=-1, keepdim=True) & sig & (mag == mag.amax(dim=-1, keepdim=True)))
    any_anchor = anch.any(dim=-1, keepdim=True)
    bpt = old_bins_per_thread(n_bins)
    n_pad = -(-n_bins // (32 * bpt)) * 32 * bpt
    big = float(10 * n_bins)
    ct, sup, sdn = (v.to(dtype) for v in (ct, sup, sdn))
    out = torch.empty((B, T, n_bins), dtype=dtype)
    src = torch.full((B, T, n_bins), -1, dtype=torch.long)
    k = torch.arange(n_bins)
    phi = torch.zeros((B, n_bins), dtype=dtype) if prev_phase is None else prev_phase.to(dtype)
    for t in range(T):
        if t and t % T_c == 0:
            m = mag[:, t - 1].to(dtype)
            phi = torch.atan2(m * torch.sin(phi), m * torch.cos(phi))
        a_s = anch[:, t]
        phi = old_fill_frame(phi, ct[:, t], a_s, sup[:, t], sdn[:, t], any_anchor[:, t], sig[:, t],
                             angles[:, t], bpt, n_pad, big, dtype)
        out[:, t] = phi
        # the anchor each bin fills from, by the scans' distance channels
        pad = (0, n_pad - n_bins)
        a0 = (~a_s).to(dtype)
        a2 = torch.stack([torch.nn.functional.pad(a0, pad, value=1.0),
                          torch.nn.functional.pad(a0, pad, value=1.0).flip(-1)])
        d2 = torch.stack([torch.nn.functional.pad(a0, pad), torch.nn.functional.pad(a0, pad).flip(-1)])
        sa, _, sd = old_block_scan((a2, torch.zeros_like(a2), d2), bpt)
        du = torch.where(sa[0, :, :n_bins] == 0, sd[0, :, :n_bins], big)
        dd = torch.where(sa[1].flip(-1)[:, :n_bins] == 0, sd[1].flip(-1)[:, :n_bins], big)
        s = torch.where(du <= dd, k - du.long(), k + dd.long())
        s = torch.where(a_s, k, s)
        src[:, t] = torch.where(sig[:, t] & any_anchor[:, t], s, -1)
    return out, src, src_new, anch


def drifting_mags(B, T, n_bins, seed, quiet=0.1):
    """Ridges drifting in frequency over noise; a share of the frames near
    silence, so that the next frame takes the onset rule."""
    rng = np.random.default_rng(seed)
    t, k = np.arange(T)[:, None], np.arange(n_bins)[None, :]
    m = 1e-3 * rng.random((B, T, n_bins))
    for b in range(B):
        for _ in range(6):
            c, w, a = rng.uniform(2, n_bins - 3), rng.uniform(1, 4), rng.uniform(0.2, 1)
            m[b] += a * np.exp(-0.5 * ((k - c - 0.07 * t) / w) ** 2)
        m[b, rng.random(T) < quiet] *= 1e-6
    return torch.as_tensor(m.astype(np.float32))


@pytest.mark.parametrize("n_bins,t_c,seeded", [(513, 16, False), (385, 8, False), (513, 22, True),
                                               (33, 4, False)])
def test_against_the_old_schedule_in_float64(n_bins, t_c, seeded):
    """The same anchors and the same source for every bin as the schedule
    before; phases within ``T_c`` x 2 ulp of the chunk's largest phase of
    its float64 run."""
    n_fft = 2 * (n_bins - 1)
    hop, gamma, tol = n_fft // 4, 0.25645 * n_fft * n_fft, 1e-2
    T = t_c if seeded else 4 * t_c
    mag = drifting_mags(2, T, n_bins, 40 + n_bins)
    ang = torch.as_tensor(np.random.default_rng(1).uniform(0, 2 * np.pi, (2, T, n_bins)).astype(np.float32))
    prev = pp = None
    if seeded:
        prev = drifting_mags(2, 2, n_bins, 7)
        pp = torch.as_tensor(np.random.default_rng(2).uniform(-np.pi, np.pi, (2, n_bins)).astype(np.float32))
    args = (gamma, n_fft, hop, tol, t_c)
    got = PK.rt_pghi_phases_reference(mag, ang, *args, prev_mag=prev, prev_phase=pp)
    ref, src_old, src_new, anch = old_schedule(mag, ang, *args, prev_mag=prev, prev_phase=pp)
    assert anch.any(dim=-1).float().mean() > 0.8          # most frames have an anchor, the quiet ones none
    assert torch.equal(torch.where(src_new >= 0, src_new, -1), src_old)
    scale = ref.abs().reshape(2, T // t_c, -1).amax(dim=-1).repeat_interleave(t_c, dim=1)[..., None]
    ulp = scale * 2.0 ** -23
    err = (got.double() - ref).abs()
    assert (err <= t_c * 2 * ulp).all(), float((err / ulp).max())


def test_onset_frames_and_a_silent_chunk():
    """A chunk of silence is its angles bit for bit (no bin audible, no
    anchor); the frame after it has no anchor by the peak rule (the previous
    frame is silent), so its audible bins equal to the frame's maximum seed
    it, and every other audible bin fills from the nearest of them."""
    n_bins, t_c, n_fft = 129, 4, 256
    mag = drifting_mags(2, 3 * t_c, n_bins, 3, quiet=0.0)
    mag[:, t_c: 2 * t_c] = 0.0
    ang = torch.as_tensor(np.random.default_rng(4).uniform(0, 2 * np.pi, (2, 3 * t_c, n_bins)).astype(np.float32))
    args = (0.25645 * n_fft * n_fft, n_fft, n_fft // 4, 1e-2, t_c)
    got = PK.rt_pghi_phases_reference(mag, ang, *args)
    assert torch.equal(got[:, t_c: 2 * t_c], ang[:, t_c: 2 * t_c])
    src, ct, seg = PK.rt_fill_plan(mag, ang, *args)
    assert (src[:, t_c: 2 * t_c] == -1).all()
    t = 2 * t_c                                          # the onset frame
    m = mag[:, t]
    thr = torch.clamp_min(1e-2 * mag[:, 2 * t_c:].reshape(2, -1).amax(-1), EPS)[:, None]
    peak = m == m.amax(dim=-1, keepdim=True)
    loud = m > thr
    for b in range(2):
        anchors = peak[b].nonzero()[:, 0]
        assert len(anchors) >= 1
        s = src[b, t]
        assert torch.equal(s[anchors], anchors)
        audible = loud[b].nonzero()[:, 0]
        near = anchors[(audible[:, None] - anchors[None, :]).abs().argmin(dim=1)]
        assert torch.equal(s[audible], near)
        assert (s[~loud[b]] == -1).all() and torch.equal(seg[b, t][~loud[b]], ang[b, t][~loud[b]])
        # an anchor's phase is the carry plus ct, unchanged by its zero sum: at
        # this chunk boundary the carry is the angle of the silent frame's
        # m e^{i phi}, 0 or +-pi by the signs of its zero parts
        z = mag[b, t - 1]
        carry = torch.atan2(z * torch.sin(got[b, t - 1]), z * torch.cos(got[b, t - 1]))
        assert torch.equal(got[b, t, anchors], carry[anchors] + ct[b, t, anchors])
    ref, src_old, src_new, _ = old_schedule(mag, ang, *args)
    assert torch.equal(torch.where(src_new >= 0, src_new, -1), src_old)


def test_the_plan_is_a_pure_function_of_the_bins_and_the_chunk():
    """For every number of bins up to 4096 and chunks of 1 to 64 frames the
    plan fits shared memory and the kernel's limits (stages within a chunk,
    of even size; a producer warp a frame), the same arguments give the same
    plan, a seeded session (one chunk) takes the plan of its chunk; more
    bins or no frame raise.  The plan's caps, 16 frames a stage and 24
    warps, are the limits the kernel's entry refuses beyond."""
    cu = (pathlib.Path(PK.__file__).parents[2] / "csrc" / "pghi.cu").read_text()
    assert f"kRtStage = {PK._RT_STAGE};" in cu and f"kRtWarps = {PK._RT_WARPS};" in cu
    assert "S > kRtStage" in cu and "P + C > kRtWarps" in cu
    for n_bins in range(2, PK.RT_MAX_BINS + 1):
        for t_c in (1, 3, 8, 16, 22, 64):
            plan = PK._rt_plan(n_bins, t_c)
            stage, producers, chain = plan
            assert plan == PK._rt_plan(n_bins, t_c)
            assert 1 <= stage <= min(t_c, PK._RT_STAGE) and PK._RT_STAGE == 16
            per_chunk = -(-t_c // stage)
            assert t_c - (per_chunk - 1) * stage >= 1 and per_chunk * stage - t_c < per_chunk
            assert producers == min(stage, 24 - chain) and chain == min(4, -(-n_bins // 256))
            assert PK._rt_smem_bytes(n_bins, stage) <= MAX_SMEM
    assert PK._rt_plan(513, 16) == (16, 16, 3)
    assert PK._rt_plan(513, 22) == (11, 11, 3)
    assert PK._rt_plan(1025, 16)[0] == 8 and PK._rt_plan(2049, 16)[0] == 3
    assert PK._rt_plan(4096, 16) == (1, 1, 4)
    for bad in ((4097, 16), (1, 16), (513, 0)):
        with pytest.raises(ValueError):
            PK._rt_plan(*bad)
    assert PK.kernel_covers("recurrence", 8190, 4095) and not PK.kernel_covers("recurrence", 8192, 2048)


def test_k_recurrence_plain_version_is_unchanged():
    """K's plain version on its new schedule (``pghi_kernel``: the plan over
    every frame at once, ``fill_sources`` shared with the streaming
    recurrence, then the walk, ``phi[src] + (ct[src] + seg)``) is the
    recurrence its old schedule computed (``test_torch_common.old_k_phases``:
    ``phi + ct`` at the anchors, two segmented scans of affine maps a frame):
    run both in float64 on the same inputs, they agree within 1e-9 of the
    largest phase (the same anchors and sources, sums in another order).
    Frames near silence take the onset rule; a clip is silent; the streaming
    module keeps no fill of its own."""
    assert not hasattr(PK, "_fill_scan") and not hasattr(PK, "_fill_frame") and not hasattr(KK, "_fill_frame")
    assert not hasattr(KK, "_block_scan") and not hasattr(KK, "_bins_per_thread")
    for (n_bins, T), bidir in itertools.product(((257, 24), (385, 13)), (False, True)):
        n_fft = 2 * (n_bins - 1)
        mag = drifting_mags(3, T, n_bins, 5 + n_bins)
        mag[2] = 0.0
        ang = torch.as_tensor(np.random.default_rng(6).uniform(0, 2 * np.pi, (3, T, n_bins)).astype(np.float32))
        args = (mag, ang, 0.25645 * n_fft * n_fft, n_fft, n_fft // 4, 1e-2, bidir, torch.float64)
        new, old = KK._phases_reference(*args), old_k_phases(*args)
        assert new.dtype == old.dtype == torch.float64 and torch.equal(new[2], ang[2].double())
        assert (new - old).abs().max() <= 1e-9 * old.abs().max()
