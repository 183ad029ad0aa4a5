"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
through the JAX package and through its PyTorch port (``device="cpu"``, where
the port's kernel wrappers run their plain PyTorch versions), and the fitted
state of a JAX chain is handed to the port as numpy arrays.
"""
import numpy as np
import torch

import acids_transforms_tpu.transforms as JT
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch.convert import load_jax_state, state_from_leaves

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
