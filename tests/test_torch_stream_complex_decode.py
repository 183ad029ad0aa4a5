"""The complex (explicit-phase) streaming decode of the port, session S
(``ops/cuda/stream_step.py:make_fused_complex_invert``, ``streaming.scan_invert``
of a complex spectrum), against

* the JAX package's Pallas kernel in interpret mode: within 1e-4 of the
  largest value (its products are bf16x4);
* a float64 numpy oracle (``np.fft.irfft``, explicit overlap-add): within
  1e-5;
* the port's own generic chunk scan: within 1e-5 (float32 sums in another
  order);
* the complex roundtrip L: S after R equals L within 1e-5.

On the CPU the session wrapper runs the plain version; the CUDA kernel is held
against it on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import acids_transforms_tpu.transforms as JT
from acids_transforms_tpu.ops.pallas import stream_step as JK
import acids_transforms_tpu_torch.transforms as PT
from acids_transforms_tpu_torch import streaming as PS
from acids_transforms_tpu_torch.ops.cuda import stream_step as PK
from test_torch_common import make_audio, rel, t2n
from test_torch_stream_kernel import oracle

CHUNK = 1024


def pair(kind, n_fft, hop):
    if kind == "dgt":
        return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeDGT(n_fft=n_fft, hop_length=hop),
                PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeDGT(n_fft=n_fft, hop_length=hop, device="cpu"))
    return (JT.OverlapAdd(n_fft, hop) + JT.RealtimeSTFT(n_fft=n_fft, hop_length=hop),
            PT.OverlapAdd(n_fft, hop, device="cpu") + PT.RealtimeSTFT(n_fft=n_fft, hop_length=hop, device="cpu"))


@pytest.fixture(scope="module")
def x():
    return make_audio(21, batch=2, n=3 * CHUNK + 300)[:, 0]  # 4 chunks, ragged tail


@pytest.mark.parametrize("kind", ["stft", "dgt"])
def test_s_decode_vs_pallas_oracle_and_generic(x, kind):
    n_fft, hop = 512, 128
    T_c = CHUNK // hop
    jc, pc = pair(kind, n_fft, hop)
    spec, _ = PK.make_fused_forward_session(pc, CHUNK)(torch.as_tensor(x))
    spec = spec[:, :-3]                                   # a ragged last chunk of frames
    T = spec.shape[1]
    y_k = PK.make_fused_complex_invert(pc, T_c)(spec)
    y_j = JK.make_fused_complex_invert(jc, T_c, interpret=True)(jnp.asarray(t2n(spec)))
    assert y_k.shape == y_j.shape == (2, T * hop)
    assert rel(t2n(y_k), np.array(y_j)) <= 1e-4
    rt = pc[1]
    _, y_o = oracle(None, None, t2n(rt.inv_window), 4.0, n_fft, hop, T, spec=np.complex128(t2n(spec)))
    assert rel(t2n(y_k), y_o) <= 1e-5
    y_g = PS.scan_invert(pc, spec, T_c, backend="generic")
    assert rel(t2n(y_k), t2n(y_g)) <= 1e-5
    assert rel(t2n(PS.scan_invert(pc, spec, T_c, backend="fused")), t2n(y_k)) == 0.0
    # one stream without a batch axis
    y1 = PK.make_fused_complex_invert(pc, T_c)(spec[0])
    assert y1.shape == (T * hop,) and rel(t2n(y1), t2n(y_k[0])) <= 1e-6


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 64), (1024, 128)])
def test_s_after_r_equals_the_complex_roundtrip(x, n_fft, hop):
    """Encode then complex decode is the complex roundtrip L (the same
    frames, the same synthesis), overlap 4 and 8."""
    _, pc = pair("stft", n_fft, hop)
    xt = torch.as_tensor(x)
    spec, _ = PK.make_fused_forward_session(pc, CHUNK)(xt)
    y_s = PK.make_fused_complex_invert(pc, CHUNK // hop)(spec)
    y_l = PK.make_fused_roundtrip(pc, CHUNK)(xt)
    assert y_s.shape == y_l.shape and rel(t2n(y_s), t2n(y_l)) <= 1e-5


def test_s_gates_and_kernel_limits():
    _, pc = pair("stft", 512, 128)
    assert PK.fused_complex_invert_available(pc, 8) and not PK.fused_complex_invert_available(pc[0], 8)
    assert not PK.fused_complex_invert_available(pc, 3)       # chunk shorter than n_fft
    wide = PT.OverlapAdd(8192, 1024, device="cpu") + PT.RealtimeSTFT(n_fft=8192, hop_length=1024, device="cpu")
    assert PK.fused_complex_invert_available(wide, 8) and not PK.kernel_covers("decode", 8192, 1024)
    # nothing counts a launch on the CPU
    PK.reset_launches()
    PK.make_fused_complex_invert(pc, 8)(torch.zeros(2, 20, 257, dtype=torch.complex64))
    assert all(v == 0 for v in PK.launches.values())
