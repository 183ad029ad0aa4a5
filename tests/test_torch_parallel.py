"""The port's parallel layer (``acids_transforms_tpu_torch/parallel``, the
``mesh=`` legs of ``fuse``, ``streaming``, ``serving`` and ``export``, and the
collective recorder) on the CPU, against the JAX package on its virtual CPU
mesh.

The port side runs in one module-scoped ``torch.multiprocessing.spawn`` of 4
gloo ranks (``tests/torch_parallel_ranks.py``: no ``jax`` there); the JAX side
runs in this process on 4 of ``tests/conftest.py``'s 8 virtual devices while
the ranks work.  Error paths that need no neighbour run here on a one-rank
gloo group.

Tolerances: a sharded call against the port's own unsharded call
bit-identical where both run the same code per row (the forwards, the encode,
the server, the extrema), sums within 1e-12 relative (float64 partials added
in another order); against the JAX package the fused forward within 2e-4
relative (``tests/test_parallel.py:170-187``), extrema and sums within 1e-5
(``tests/test_torch_spectral_kernel.py:110-112``: the JAX package sums in
float32), ``count`` exact; the sequence-parallel STFT / ISTFT
within 1e-5 of the largest value, the roundtrip within 1e-5 on the interior;
keyed (phaseless) sessions draw other angles per shard, so their spectral
convergence must lie within ``1.1 s + 1e-3`` of the unsharded run's
(``bench.py:566-575``).
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import torch_parallel_ranks as R
from test_torch_common import rel

WORLD = 4
N_FFT, HOP = R.N_FFT, R.HOP


def _jax_side():
    """The JAX package's sharded calls on the same inputs, on 4 devices."""
    from acids_transforms_tpu import transforms as JT
    from acids_transforms_tpu.fuse import _norm_from_stats, _sharded_stats, fuse_forward
    from acids_transforms_tpu.ops.fft import istft, stft
    from acids_transforms_tpu.ops.pallas.spectral import fused_melspec_stats
    from acids_transforms_tpu.ops.windows import hann_window
    from acids_transforms_tpu.parallel import make_mesh, sequence_parallel_stft
    from acids_transforms_tpu.transforms.base import ComposeAudioTransform

    inp = R.inputs()
    out = {}
    mesh = make_mesh({"data": WORLD}, jax.devices()[:WORLD])
    chain = JT.Mono() + JT.STFT(n_fft=N_FFT, hop_length=HOP) + JT.Magnitude(
        mode="unipolar", contrast="log1p", mel=True, n_fft=N_FFT)
    mono, stft_t, mag_t = chain.transforms
    x = jnp.asarray(inp["x_fuse"])
    flat = mono.forward(x).reshape((-1, x.shape[-1]))
    # fuse_fit(chain, backend="pallas", mesh=mesh) step by step, so that the
    # combined statistics themselves can be compared
    st = _sharded_stats(
        lambda f: fused_melspec_stats(f, N_FFT, HOP, stft_t.window, "log1p", taps=stft_t._window_taps),
        flat, mesh, "data")
    out["stats"] = {k: np.float64(st[k]) for k in ("sum", "sumsq", "min", "max")}
    out["stats"]["count"] = int(st["count"])
    fitted = ComposeAudioTransform(
        transforms=[mono, stft_t, mag_t.replace(norm=_norm_from_stats(mag_t.norm, st, st["count"]))], sr=chain.sr)
    out["forward"] = np.asarray(fuse_forward(fitted, mesh=mesh)(x))
    w = hann_window(N_FFT)
    smesh = make_mesh({"seq": WORLD}, jax.devices()[:WORLD])
    out["seq_stft"] = np.asarray(sequence_parallel_stft(jnp.asarray(inp["x_seq"]), N_FFT, HOP, w, smesh))
    out["istft"] = np.asarray(istft(jnp.asarray(inp["spec_seq"]), N_FFT, HOP, w, center=False))
    out["stft_2d"] = np.asarray(stft(jnp.asarray(inp["x_2d"]), N_FFT, HOP, w, center=False))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results and the JAX side's, computed side by side."""
    out_dir = tmp_path_factory.mktemp("ranks")
    ctx = mp.spawn(R.main, args=(WORLD, str(out_dir / "store"), str(out_dir)), nprocs=WORLD, join=False)
    jx = _jax_side()
    while not ctx.join():
        pass
    ranks = []
    for r in range(WORLD):
        with np.load(out_dir / ("rank%d.npz" % r)) as f:
            d = dict(f)
        d["records"] = {k: [tuple(e) for e in v] for k, v in json.loads(str(d["records"])).items()}
        ranks.append(d)
    return ranks, jx, R.inputs()


def _same_on_every_rank(ranks, key):
    return all(np.array_equal(r[key], ranks[0][key]) for r in ranks[1:])


def test_fuse_forward_mesh_matches_direct_and_jax(world):
    ranks, jx, inp = world
    for r, d in enumerate(ranks):
        for be in ("kernel", "eager"):
            assert np.array_equal(d["forward_" + be], d["forward_one_" + be]), (r, be)
            assert str(d["forward_placement_" + be]) == "(Shard(dim=0),)"
            np.testing.assert_array_equal(d["forward_local_" + be], d["forward_one_" + be][2 * r: 2 * r + 2])
        assert np.array_equal(d["forward_dtensor"], d["forward_kernel"])
    y = ranks[0]["forward_kernel"]
    assert y.shape == jx["forward"].shape == (8, 8192 // HOP + 1, N_FFT // 2 + 1)
    assert rel(y, jx["forward"]) <= 2e-4


def test_fuse_fit_mesh_combines_exactly(world):
    ranks, jx, _ = world
    d = ranks[0]
    assert _same_on_every_rank(ranks, "fit_mesh")
    # unipolar: offset = min, scale = max - min, bit-identical to one device
    np.testing.assert_array_equal(d["fit_mesh"], d["fit_one"])
    for k in ("min", "max"):
        assert d["stats_mesh_" + k] == d["stats_one_" + k], k
    for k in ("sum", "sumsq"):
        assert abs(d["stats_mesh_" + k] - d["stats_one_" + k]) <= 1e-12 * abs(d["stats_one_" + k]), k
    count = 8 * (8192 // HOP + 1) * (N_FFT // 2 + 1)
    assert int(d["stats_mesh_count"]) == int(d["stats_one_count"]) == jx["stats"]["count"] == count
    js = jx["stats"]
    assert abs(d["stats_mesh_min"] - js["min"]) <= 1e-5
    assert abs(d["stats_mesh_max"] - js["max"]) <= 1e-5 * abs(js["max"])
    # the JAX package's partial sums and their psum are float32 (measured
    # 3.8e-6 off the port's float64 sum here): the rule of
    # tests/test_torch_spectral_kernel.py:110
    for k in ("sum", "sumsq"):
        assert abs(d["stats_mesh_" + k] - js[k]) <= 1e-5 * abs(js[k]), k


def test_sequence_parallel_stft_istft(world):
    ranks, jx, inp = world
    d = ranks[0]
    L = inp["x_seq"].shape[-1]
    sp, one = d["seq_stft"], d["seq_stft_one"]
    assert sp.shape == jx["seq_stft"].shape == (2, L // HOP, N_FFT // 2 + 1)
    m = one.shape[-2]            # the unsharded center=False frames; the rest frame the zeros past the end
    assert rel(sp[..., :m, :], one) <= 1e-5
    assert rel(sp, jx["seq_stft"]) <= 1e-5
    inner = slice(N_FFT, L - N_FFT)
    assert d["seq_roundtrip"].shape == (2, L)
    assert np.abs(d["seq_roundtrip"][..., inner] - inp["x_seq"][..., inner]).max() <= 1e-5
    n = d["seq_istft"].shape[-1]
    assert n == inp["spec_seq"].shape[-2] * HOP
    assert rel(d["seq_istft"], d["seq_istft_one"][..., :n]) <= 1e-5
    assert rel(d["seq_istft"], jx["istft"][..., :n]) <= 1e-5
    assert "halo" in str(d["seq_err_halo"])
    assert all(_same_on_every_rank(ranks, k) for k in ("seq_stft", "seq_roundtrip", "seq_istft"))


def test_2d_mesh_batch_and_seq_sharded(world):
    ranks, jx, inp = world
    d = ranks[0]
    L = inp["x_2d"].shape[-1]
    m = jx["stft_2d"].shape[-2]
    assert str(d["seq2d_placements"]) == "(Shard(dim=0), Shard(dim=1))"
    assert rel(d["seq2d_stft"][..., :m, :], jx["stft_2d"]) <= 1e-5
    inner = slice(N_FFT, L - N_FFT)
    assert np.abs(d["seq2d_roundtrip"][..., inner] - inp["x_2d"][..., inner]).max() <= 1e-5


def test_scan_forward_mesh_matches_one_device(world):
    ranks, _, _ = world
    for d in ranks:
        for be in ("fused", "generic"):
            a, b = d["scan_forward_" + be], d["scan_forward_one_" + be]
            assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
            assert d["scan_state_" + be].max() <= 1e-5
        np.testing.assert_array_equal(d["scan_times"], d["scan_times_one"])
        assert np.array_equal(d["scan_invert_complex"], d["scan_invert_one_complex"])


def _convergence(y, x):
    n = min(y.shape[-1], x.shape[-1])
    w = torch.hann_window(N_FFT, dtype=torch.float64)
    S = lambda s: torch.stft(torch.as_tensor(s[..., :n], dtype=torch.float64), N_FFT, HOP, window=w,
                             return_complex=True).abs()
    a, b = S(y), S(x)
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def test_scan_phaseless_mesh_keyed(world):
    """Keyed sessions draw per shard: other values than one device's, the
    same quality."""
    ranks, _, inp = world
    d = ranks[0]
    x = inp["x_scan"]
    delay = N_FFT - HOP
    for key in ("scan_roundtrip_random", "scan_roundtrip_pghi"):
        ym, y1 = d[key], d[key.replace("scan_roundtrip_", "scan_roundtrip_one_")]
        assert ym.shape == y1.shape and np.isfinite(ym).all()
        s_m, s_1 = _convergence(ym[..., delay:], x), _convergence(y1[..., delay:], x)
        assert s_m <= 1.1 * s_1 + 1e-3, (key, s_m, s_1)
    assert not np.array_equal(d["scan_roundtrip_random"], d["scan_roundtrip_one_random"])
    yi, y1 = d["scan_invert_random"], d["scan_invert_one_random"]
    assert yi.shape == y1.shape and np.isfinite(yi).all()
    assert _convergence(yi[..., delay:], x) <= 1.1 * _convergence(y1[..., delay:], x) + 1e-3
    assert all(_same_on_every_rank(ranks, k) for k in ("scan_roundtrip_random", "scan_invert_random"))


def test_serving_mesh(world):
    ranks, _, _ = world
    d = ranks[0]
    assert np.array_equal(d["serve_forward"], d["serve_forward_one"])
    assert d["serve_invert"].shape == d["serve_invert_one"].shape
    assert np.abs(d["serve_invert"] - d["serve_invert_one"]).max() <= 1e-5
    assert np.array_equal(d["serve_short"], d["serve_forward"][:3])
    assert np.isfinite(d["serve_phaseless"]).all() and d["serve_phaseless"].shape[0] == 8
    assert "mesh" in str(d["serve_err"]) and "[2]" in str(d["serve_err"])
    # the live session: the encode as one device's, the decode per shard
    np.testing.assert_array_equal(d["session_encode"], d["session_encode_one"])
    assert d["session_decode"].shape == (2, 8, 1024) and np.isfinite(d["session_decode"]).all()
    assert "batch" in str(d["session_err"])


def test_collectives_per_leg(world):
    from acids_transforms_tpu_torch.utils.collectives import collective_violations

    ranks, _, _ = world
    for d in ranks:
        rec = d["records"]
        for leg in ("forward_kernel", "forward_eager", "scan_forward_fused", "scan_forward_generic",
                    "scan_roundtrip_random", "scan_roundtrip_pghi", "scan_invert_random", "serve_forward",
                    "serve_invert", "session", "export"):
            assert rec[leg] == [], (leg, rec[leg])
        for leg in ("fit", "stats"):
            # the scalar combine: three all-reduces (sums, minima, maxima)
            assert [op for op, _ in rec[leg]] == ["all_reduce"] * 3, rec[leg]
            assert collective_violations(rec[leg]) and not collective_violations(rec[leg],
                                                                                 allow_scalar_all_reduce=True)
        # the halo exchange: point-to-point only, one halo a neighbour
        assert {op for op, _ in rec["seq_stft"]} <= {"send", "recv"} and rec["seq_stft"]
        assert all(n == 2 * (N_FFT - HOP) for _, n in rec["seq_stft"])
        # a request short of its batch bucket gathers its rows for the trim
        assert [op for op, _ in rec["serve_short"]] == ["all_gather"]
        # the checker's control: a planted batch-shaped all-reduce is caught
        # under both policies, a scalar one only by the forward policy
        planted = rec["planted_batch"]
        assert any(op == "all_reduce" and n >= 128 for op, n in planted)
        assert collective_violations(planted, allow_scalar_all_reduce=True)
        assert collective_violations(rec["planted_scalar"])
        assert not collective_violations(rec["planted_scalar"], allow_scalar_all_reduce=True)
    assert collective_violations([("all_reduce", -1)], allow_scalar_all_reduce=True) == [("all_reduce", -1)]


def test_shard_map_batch_edge_cases(world):
    ranks, _, _ = world
    d = ranks[0]
    assert "divisible" in str(d["smb_err_divisible"])
    for key in ("smb_err_rank1", "scan_err_rank1", "scan_err_unbatched"):
        assert "batch axis" in str(d[key]), key
    # B == mesh size: a replicated lead-1 output stays replicated
    np.testing.assert_array_equal(d["smb_lead1_y"], np.arange(32, dtype=np.float32).reshape(4, 8) * 2)
    assert d["smb_lead1_table"].shape == (1, 3) and str(d["smb_lead1_table_placements"]) == "(Replicate(),)"
    # keyed: the shards draw differently, and reproducibly from the same seed
    k = d["smb_keyed"]
    assert k.shape == (4, 16) and not any(np.allclose(k[i], k[j]) for i in range(4) for j in range(i))
    np.testing.assert_array_equal(k, d["smb_keyed_again"])


def test_export_program_in_shardings_roundtrip(world):
    ranks, _, _ = world
    for d in ranks:
        assert np.array_equal(d["export"], d["export_one"])
        assert "acids_transforms_tpu_torch.fused_melspec.default" in list(d["export_nodes"])
        sh = json.loads(str(d["export_sharding"]))
        assert sh["axis"] == "data" and sh["mesh_size"] == WORLD and sh["batch"] == 8
        assert "exclusive" in str(d["export_err"])


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_needs_a_process_group():
    from acids_transforms_tpu_torch.parallel import local_mesh, make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    for build in (lambda: make_mesh({"data": 1}, device_type="cpu"), lambda: local_mesh(device_type="cpu")):
        with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
            build()


def test_one_rank_error_paths(one_rank):
    from acids_transforms_tpu_torch import fuse, serving, streaming
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.parallel import local_mesh, make_mesh, shard_map_batch

    with pytest.raises(ValueError, match="does not cover 1 devices"):
        make_mesh({"data": 2}, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            local_mesh()
    mesh = local_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
    with pytest.raises(ValueError, match="no axis 'seq'"):
        shard_map_batch(lambda v: v, mesh, "seq")
    chain = T.Mono(device="cpu") + T.STFT(n_fft=N_FFT, hop_length=HOP, device="cpu") + T.Magnitude(
        n_fft=N_FFT, device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        fuse.fuse_forward(chain, mesh=mesh)(torch.zeros(4096))
    with pytest.raises(ValueError, match="batch axis"):
        fuse.fuse_fit(chain, backend="kernel", mesh=mesh)(torch.zeros(4096))
    rt = T.OverlapAdd(N_FFT, HOP, device="cpu") + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        streaming.scan_roundtrip(rt, torch.zeros(4096), 2048, "random", mesh=mesh)
    with pytest.raises(ValueError, match="batched session"):
        serving.StreamingSession(rt, 1024, mesh=mesh)
    # a world of one: the sharded forward is the direct one, bit for bit
    x = torch.randn(2, 1, 4096, generator=torch.Generator().manual_seed(0))
    fitted = fuse.fuse_fit(chain, backend="kernel", mesh=mesh)(x)
    y = fuse.fuse_forward(fitted, backend="kernel", mesh=mesh)(x)
    assert torch.equal(y.to_local(), fuse.fuse_forward(fitted, backend="kernel")(x))
