"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
through the JAX package and through its PyTorch port (``device="cpu"``, where
the port's kernel wrappers run their plain PyTorch versions), and the fitted
state of a JAX chain is handed to the port as numpy arrays.
"""
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.convert import load_jax_state, state_from_leaves
from acids_transforms_tpu_torch.ops.cuda import pghi_kernel as PK
from acids_transforms_tpu_torch.ops.pghi import EPS

torch.set_num_threads(1)

N_FFT, HOP, SR = 512, 128, 44100


def make_audio(seed: int, batch: int = 2, n: int = 9000, channels: int = 2) -> np.ndarray:
    """Seeded stereo test audio: harmonics with a decaying noise burst."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.zeros((batch, channels, n))
    for b in range(batch):
        f0 = rng.uniform(150, 900)
        for h in range(1, 5):
            x[b] += np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6.28, (channels, 1))) / h
        x[b] += 0.3 * np.exp(-t * 30) * rng.standard_normal((channels, n))
    x += 0.01 * rng.standard_normal(x.shape)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def rel(a, b) -> float:
    """max-abs of the difference over max-abs of the reference ``b``."""
    a, b = np.asarray(a), np.asarray(b)
    wide = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) else np.float64
    a, b = a.astype(wide), b.astype(wide)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(torch.float32).cpu().numpy() if not x.is_complex() else x.detach().cpu().numpy()


def chains(n_fft=N_FFT, hop=HOP, window="hann", gl_iterations=6, **mag_kw):
    """The flagship chain in both packages, unfitted."""
    kw = dict(mode="unipolar", contrast="log1p", mel=True, n_fft=n_fft)
    kw.update(mag_kw)
    jc = JT.Mono() + JT.STFT(n_fft=n_fft, hop_length=hop, window=window,
                             gl_iterations=gl_iterations) + JT.Magnitude(**kw)
    pc = PT.Mono(device="cpu") + PT.STFT(
        n_fft=n_fft, hop_length=hop, window=window, gl_iterations=gl_iterations, device="cpu"
    ) + PT.Magnitude(device="cpu", **kw)
    return jc, pc


def dgt_chains(n_fft=N_FFT, hop=HOP, inversion_mode="pghi", **mag_kw):
    """The DGT magnitude chain in both packages, unfitted."""
    kw = dict(mode="unipolar", contrast="log1p", mel=False, n_fft=n_fft)
    kw.update(mag_kw)
    jc = JT.Mono() + JT.DGT(n_fft=n_fft, hop_length=hop, inversion_mode=inversion_mode) + JT.Magnitude(**kw)
    pc = PT.Mono(device="cpu") + PT.DGT(
        n_fft=n_fft, hop_length=hop, inversion_mode=inversion_mode, device="cpu"
    ) + PT.Magnitude(device="cpu", **kw)
    return jc, pc


def fitted_dgt_chains(seed: int = 21, batch: int = 3, n: int = 9000, **kw):
    """Seeded DGT-chain fixture: the audio, the JAX chain fitted on it and the
    port chain holding the same state (JAX leaves carried over as numpy)."""
    import jax.numpy as jnp

    jc, pc = dgt_chains(**kw)
    x = make_audio(seed, batch=batch, n=n)
    jf = jc.fit(jnp.asarray(x))
    carry_over(jf, pc)
    return x, jf, pc


def jax_angles(shape, seed: int = 0) -> np.ndarray:
    """``2 pi uniform(PRNGKey(seed))``: the JAX scan's draw for silent bins,
    to pin the port's ``angles=`` to."""
    import jax
    import jax.numpy as jnp

    return np.array(2.0 * jnp.pi * jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype=jnp.float32))


def tones(n: int, freqs, sr: int = SR) -> np.ndarray:
    """One clip per entry of ``freqs`` (a frequency or a tuple of partials):
    low-pitched sines, whose audible bins keep small carrier phases, so float32
    phases of both packages agree to 1e-3 whatever the order of additions."""
    t = np.arange(n) / sr
    out = []
    for f in freqs:
        fs = f if isinstance(f, (tuple, list)) else (f,)
        out.append(sum(np.sin(2 * np.pi * fi * t) / (i + 1) for i, fi in enumerate(fs)))
    x = np.stack(out)
    return (0.7 * x / np.abs(x).max()).astype(np.float32)


def _leaves_of(t):
    """Array leaves of one JAX transform as nested numpy mappings, taken from
    its pytree flattening (``transforms/base.py:_tree_flatten``)."""
    leaves, _ = t._tree_flatten()
    out = {}
    for name, leaf in zip(type(t)._leaves, leaves):
        if name == "rng":
            continue  # PRNG keys do not carry across frameworks
        if isinstance(leaf, JT.AudioTransform):
            sub = _leaves_of(leaf)
            out[name] = sub if sub else None
        else:
            out[name] = np.asarray(leaf)
    if isinstance(t, JT.Normalize):
        out["needs_scaling"] = bool(t.needs_scaling)
    return out


def jax_state(jchain):
    """The keyed numpy state ``convert.load_jax_state`` takes."""
    children = jchain.transforms if isinstance(jchain, JT.ComposeAudioTransform) else [jchain]
    return state_from_leaves([_leaves_of(t) for t in children])


def carry_over(jchain, pchain):
    """Load the JAX chain's leaves into the port chain (in place)."""
    return load_jax_state(pchain, jax_state(jchain))


def test_state_keys_of_the_flagship_chain():
    jc, pc = chains()
    x = make_audio(0)
    import jax.numpy as jnp

    st = jax_state(jc.fit(jnp.asarray(x)))
    assert set(st) == {
        "1.window", "1.inv_window", "2.mel_bank", "2.inverse_mel_bank",
        "2.norm.offset", "2.norm.scale", "2.norm.needs_scaling",
    }
    assert not bool(st["2.norm.needs_scaling"])


def test_state_keys_of_the_dgt_chain():
    _, jf, pc = fitted_dgt_chains()
    st = jax_state(jf)
    assert set(st) == {"1.window", "1.inv_window", "2.mel_bank", "2.inverse_mel_bank",
                       "2.norm.offset", "2.norm.scale", "2.norm.needs_scaling"}
    assert np.array_equal(t2n(pc[1].window), st["1.window"])
    assert pc[1]._window_taps is None and not pc[2].norm.needs_scaling


# ------------------------------------------------------------------------
# K's recurrence on the schedule its kernel had before the plan / walk design
# (a block a chain: per frame ``phi + ct`` at the anchors, then two segmented
# scans of affine maps ``x -> a x + b`` with a distance channel, composed in
# a warp-structured order): the oracle of that order of additions.
def old_bins_per_thread(n_bins: int):
    """Adjacent bins a thread of the old kernel owned (a block of at most 32
    warps), or None above 4096 bins."""
    for bpt in (1, 2, 4):
        if n_bins <= 1024 * bpt:
            return bpt
    return None


def old_chains(T: int, bidir: bool) -> List[Tuple[List[int], List[int], List[int], List[float], List[bool]]]:
    """Per chain the steps as ``(previous, current, next frame, sign, store)``;
    frame -1 is the all-zero frame before the clip."""
    if not bidir:
        s = range(T)
        return [([t - 1 for t in s], list(s), [min(t + 1, T - 1) for t in s],
                 [1.0] * T, [True] * T)]
    mid = T // 2
    right = range(mid, T)
    chain0 = ([t - 1 for t in right], list(right), [min(t + 1, T - 1) for t in right],
              [1.0] * len(right), [True] * len(right))
    left = range(mid - 1, -1, -1)
    # the left chain first repeats the right chain's seed step, unstored
    chain1 = ([mid - 1] + [t + 1 for t in left], [mid] + list(left),
              [mid + 1] + [max(t - 1, 0) for t in left],
              [1.0] + [-1.0] * mid, [False] + [True] * mid)
    return [chain0, chain1]


def old_compose(l, r):
    """Apply ``l`` (earlier) then ``r``: the maps ``x -> a x + b`` with a
    distance channel ``d``; ``a`` is 0 or 1, so each channel rounds once."""
    return (l[0] * r[0], l[1] * r[0] + r[1], l[2] * r[0] + r[2])


def old_shift(x, s: int):
    """Elements moved ``s`` places up the last axis, identity maps shifted in."""
    fill = (1.0, 0.0, 0.0)
    return tuple(F_.pad(c[..., :-s], (s, 0), value=v) if s < c.shape[-1]
                 else torch.full_like(c, v) for c, v in zip(x, fill))


def old_kogge_stone(x):
    n, s = x[0].shape[-1], 1
    while s < n:
        x = old_compose(old_shift(x, s), x)
        s *= 2
    return x


def old_block_scan(e, bpt: int):
    """Inclusive segmented scan up the last axis (length a multiple of
    ``32 * bpt``), composing in the kernel's order: inside a thread's ``bpt``
    bins, over the 32 lanes' totals, over the warps' totals, and then
    ``compose(compose(warps before, lanes before), own prefix)``."""
    lead = e[0].shape[:-1]
    n_pad = e[0].shape[-1]
    e = tuple(c.reshape(lead + (n_pad // (32 * bpt), 32, bpt)) for c in e)
    cols = [tuple(c[..., j] for c in e) for j in range(bpt)]
    for j in range(1, bpt):
        cols[j] = old_compose(cols[j - 1], cols[j])
    incl = old_kogge_stone(cols[-1])                        # (..., W, 32)
    wt = old_kogge_stone(tuple(c[..., -1] for c in incl))   # (..., W)
    wprev = tuple(c[..., None] for c in old_shift(wt, 1))
    before = old_compose(wprev, old_shift(incl, 1))
    out = [old_compose(before, col) for col in cols]
    return tuple(
        torch.stack([o[i] for o in out], dim=-1).reshape(lead + (n_pad,)) for i in range(3)
    )


def old_run_chain(m, ang, abstol, steps, fmul, carrier, dtype, out):
    """One chain of the recurrence on ``m (B, T, F)`` float32; writes the
    stored steps' phases into ``out (B, T, F)`` of ``dtype``.  The masks come
    from the float32 magnitudes whatever ``dtype`` is, so a float64 run takes
    the same discrete decisions and differs by rounding only."""
    fp, fc, fn, sgn, store = steps
    B, T, n_bins = m.shape
    dev = m.device
    bpt = old_bins_per_thread(n_bins)
    n_pad = -(-n_bins // (32 * bpt)) * 32 * bpt
    mz = torch.cat([m, m.new_zeros((B, 1, n_bins))], dim=1)   # index -1: the zero frame
    ix = lambda f: torch.as_tensor(f, device=dev) % (T + 1)
    Mp, Mc, Mn = (mz.index_select(1, ix(f)) for f in (fp, fc, fn))
    sg = torch.as_tensor(sgn, device=dev, dtype=dtype)[None, :, None]
    Yp, Yc, Yn = (torch.log(torch.clamp_min(x, EPS).to(dtype)) for x in (Mp, Mc, Mn))
    k = torch.arange(n_bins, device=dev, dtype=dtype)
    ck = carrier * k

    def tstep(Y):
        up = torch.cat([Y[..., 1:], Y[..., -1:]], dim=-1)
        dn = torch.cat([Y[..., :1], Y[..., :-1]], dim=-1)
        # times 1 / fmul, as the kernel does (a division by a constant rounds
        # otherwise, by up to an ulp)
        return ((up - dn) * 0.5) * (1.0 / fmul) + ck

    ct = sg * ((tstep(Yp) + tstep(Yc)) * 0.5)
    fs = sg * (-fmul * ((Yn - Yp) * 0.5)) + math.pi
    del Yp, Yc, Yn
    trap = (fs[..., 1:] + fs[..., :-1]) * 0.5
    zero = torch.zeros_like(fs[..., :1])
    sup = torch.cat([zero, trap], dim=-1)
    sdn = torch.cat([-trap, zero], dim=-1)
    del fs, trap
    thr = abstol[:, None, None]
    sig = Mc > thr
    mpad = F_.pad(Mc, (1, 1), value=-1.0)
    anch = sig & (Mp > thr) & (Mc >= mpad[..., :-2]) & (Mc >= mpad[..., 2:])
    onset = ~anch.any(dim=-1, keepdim=True)
    anch = anch | (onset & sig & (Mc == Mc.amax(dim=-1, keepdim=True)))
    any_anchor = anch.any(dim=-1, keepdim=True)
    del Mp, Mn, mpad

    big = float(10 * n_bins)
    phi = torch.zeros((B, n_bins), device=dev, dtype=dtype)
    for s in range(len(fc)):
        phi = old_fill_frame(phi, ct[:, s], anch[:, s], sup[:, s], sdn[:, s], any_anchor[:, s],
                          sig[:, s], ang[:, fc[s]], bpt, n_pad, big, dtype)
        if store[s]:
            out[:, fc[s]] = phi


def old_fill_frame(phi, ct, a_s, sup, sdn, any_anchor, sig, ang, bpt, n_pad, big, dtype):
    """One frame of the recurrence on ``(B, F)`` rows, in the kernel's order:
    ``phi + ct`` at the anchors, the two-sided segmented fill from them, the
    anchored / filled select, the silent bins' angles.  Returns the frame's
    phases."""
    n_bins = phi.shape[-1]
    pad = (0, n_pad - n_bins)
    phi_t = phi + ct
    a0 = (~a_s).to(dtype)
    b_up = torch.where(a_s, phi_t, sup)
    b_dn = torch.where(a_s, phi_t, sdn)
    # both directions in one scan: the downward one runs up the flipped
    # padded row (identity maps first, which change nothing)
    a2 = torch.stack([F_.pad(a0, pad, value=1.0), F_.pad(a0, pad, value=1.0).flip(-1)])
    b2 = torch.stack([F_.pad(b_up, pad), F_.pad(b_dn, pad).flip(-1)])
    d2 = torch.stack([F_.pad(a0, pad), F_.pad(a0, pad).flip(-1)])
    sa, sb, sd = old_block_scan((a2, b2, d2), bpt)
    a_u, f_up, d_up = sa[0, :, :n_bins], sb[0, :, :n_bins], sd[0, :, :n_bins]
    a_d, f_dn, d_dn = (x[1].flip(-1)[:, :n_bins] for x in (sa, sb, sd))
    du = torch.where(a_u == 0, d_up, big)
    dd = torch.where(a_d == 0, d_dn, big)
    filled = torch.where(du <= dd, f_up, f_dn)     # a tie takes the fill from below
    filled = torch.where(any_anchor, filled, torch.zeros_like(filled))
    phi = torch.where(a_s, phi_t, filled)
    return torch.where(sig, phi, ang.to(dtype))


def old_k_phases(m, ang, gamma, n_fft, hop, tolerance, bidir, dtype):
    T = m.shape[1]
    fmul = float(gamma) / (hop * n_fft)
    carrier = 2.0 * math.pi * hop / n_fft
    out = torch.empty(m.shape, device=m.device, dtype=dtype)
    for steps in old_chains(T, bidir and T >= 4):
        old_run_chain(m, ang, PK._abstol(m, tolerance), steps, fmul, carrier, dtype, out)
    return out


class Mesh4:
    """The shape of a 1-D device mesh of 4 on ``"data"``, seen from rank 0:
    enough for the checks the ``mesh=`` entry points make before a tensor is
    sliced or a rank is asked."""

    mesh_dim_names = ("data",)

    def size(self, dim=None):
        return 4

    def get_local_rank(self, dim=None):
        return 0
