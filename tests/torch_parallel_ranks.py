"""The rank side of ``tests/test_torch_parallel.py``: one gloo rank of a
4-rank world on the CPU, started by ``torch.multiprocessing.spawn``.

Each rank runs every scenario through the port's ``mesh=`` entry points and
writes what it saw to ``out_dir/rank<r>.npz`` (whole tensors gathered with
``full_tensor()``, the local part, the collectives each leg issued, and the
errors the error paths raised).  It imports neither ``jax`` nor the JAX
package: the test process holds the results against them.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist

N_FFT, HOP = 512, 128


def inputs():
    """The seeded numpy inputs both sides use."""
    rng = np.random.default_rng(19)
    return {
        "x_fuse": (0.3 * rng.standard_normal((8, 2, 8192))).astype(np.float32),
        "x_seq": rng.standard_normal((2, 4 * 16 * HOP)).astype(np.float32),
        "spec_seq": (rng.standard_normal((2, 4 * 8, N_FFT // 2 + 1))
                     + 1j * rng.standard_normal((2, 4 * 8, N_FFT // 2 + 1))).astype(np.complex64),
        "x_2d": rng.standard_normal((4, 2 * 16 * HOP)).astype(np.float32),
        "x_scan": (0.3 * rng.standard_normal((4, 4 * 2048))).astype(np.float32),
        "x_serve": (0.3 * rng.standard_normal((8, 5000))).astype(np.float32),
        "x_sess": (0.3 * rng.standard_normal((8, 2 * 1024))).astype(np.float32),
        "x_export": (0.3 * rng.standard_normal((8, 32 * 64))).astype(np.float32),
    }


def _err(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def scenarios(out: dict, records: dict, out_dir: str) -> None:
    from acids_transforms_tpu_torch import export, fuse, streaming
    from acids_transforms_tpu_torch import transforms as T
    from acids_transforms_tpu_torch.ops.fft import istft, stft
    from acids_transforms_tpu_torch.ops.windows import hann_window
    from acids_transforms_tpu_torch.parallel import local_mesh, make_mesh, sequence_parallel_istft
    from acids_transforms_tpu_torch.parallel import sequence_parallel_stft, shard_along, shard_map_batch
    from acids_transforms_tpu_torch.serving import CompiledTransform, StreamingSession
    from acids_transforms_tpu_torch.utils.collectives import record_collectives

    D = "cpu"
    inp = {k: torch.as_tensor(v) for k, v in inputs().items()}
    mesh = local_mesh(device_type=D)
    rank = dist.get_rank()

    def rec(name, fn):
        with record_collectives() as r:
            res = fn()
        records[name] = r
        return res

    # ---- the log-mel chain: sharded fit, then the sharded forward
    chain = T.Mono(device=D) + T.STFT(n_fft=N_FFT, hop_length=HOP, device=D) + T.Magnitude(
        mode="unipolar", contrast="log1p", mel=True, n_fft=N_FFT, device=D)
    x = inp["x_fuse"]
    fm = rec("fit", lambda: fuse.fuse_fit(chain, backend="kernel", mesh=mesh)(x))
    f1 = fuse.fuse_fit(chain, backend="kernel")(x)
    out["fit_mesh"] = np.array([float(fm[-1].norm.offset), float(fm[-1].norm.scale)])
    out["fit_one"] = np.array([float(f1[-1].norm.offset), float(f1[-1].norm.scale)])
    stats_fn = lambda v: fuse.fused_melspec_stats(chain[0].forward(v).reshape(-1, v.shape[-1]), N_FFT, HOP,
                                                  "log1p", taps=chain[1]._window_taps, window=chain[1].window)
    st = rec("stats", lambda: fuse._stats_over(stats_fn, x, mesh, "data"))
    st1 = stats_fn(x)
    for k in ("sum", "sumsq", "min", "max"):
        out["stats_mesh_" + k], out["stats_one_" + k] = st[k].double().numpy(), st1[k].double().numpy()
    out["stats_mesh_count"], out["stats_one_count"] = np.array(st["count"]), np.array(st1["count"])
    for backend in ("kernel", "eager"):
        ym = rec("forward_" + backend, lambda: fuse.fuse_forward(fm, backend=backend, mesh=mesh)(x))
        out["forward_" + backend] = ym.full_tensor().numpy()
        out["forward_one_" + backend] = fuse.fuse_forward(fm, backend=backend)(x).numpy()
        out["forward_placement_" + backend] = np.array(str(ym.placements))
        out["forward_local_" + backend] = ym.to_local().numpy()
    # a DTensor input sharded on its batch axis takes the same path
    xd = shard_along(x, mesh)
    out["forward_dtensor"] = fuse.fuse_forward(fm, backend="kernel", mesh=mesh)(xd).full_tensor().numpy()

    # ---- sequence parallelism, then a 2-D mesh
    w = hann_window(N_FFT)
    smesh = local_mesh(axis="seq", device_type=D)
    sp = rec("seq_stft", lambda: sequence_parallel_stft(inp["x_seq"], N_FFT, HOP, w, smesh))
    out["seq_stft"] = sp.full_tensor().numpy()
    out["seq_stft_one"] = stft(inp["x_seq"], N_FFT, HOP, w, center=False).numpy()
    out["seq_roundtrip"] = rec("seq_istft", lambda: sequence_parallel_istft(sp, N_FFT, HOP, w, smesh)).full_tensor().numpy()
    out["seq_istft"] = sequence_parallel_istft(inp["spec_seq"], N_FFT, HOP, w, smesh).full_tensor().numpy()
    out["seq_istft_one"] = istft(inp["spec_seq"], N_FFT, HOP, w, center=False).numpy()
    m2 = make_mesh({"data": 2, "seq": 2}, device_type=D)
    sp2 = sequence_parallel_stft(inp["x_2d"], N_FFT, HOP, w, m2, batch_axis="data")
    out["seq2d_stft"] = sp2.full_tensor().numpy()
    out["seq2d_placements"] = np.array(str(sp2.placements))
    out["seq2d_roundtrip"] = sequence_parallel_istft(sp2, N_FFT, HOP, w, m2, batch_axis="data").full_tensor().numpy()
    out["seq_err_halo"] = np.array(_err(lambda: sequence_parallel_stft(inp["x_seq"][..., :4 * 256], N_FFT, HOP, w,
                                                                       smesh)))

    # ---- streaming sessions
    rt = T.OverlapAdd(N_FFT, HOP, device=D) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP, device=D)
    xs = inp["x_scan"]
    for backend in ("fused", "generic"):
        spm, stm = rec("scan_forward_" + backend, lambda: streaming.scan_forward(rt, xs, 2048, backend=backend,
                                                                                 mesh=mesh))
        sp1, st1 = streaming.scan_forward(rt, xs, 2048, backend=backend)
        out["scan_forward_" + backend], out["scan_forward_one_" + backend] = spm.full_tensor().numpy(), sp1.numpy()
        out["scan_state_" + backend] = np.array([
            float((a.full_tensor() - b).abs().max()) if isinstance(a, torch.Tensor) else 0.0
            for a, b in zip(torch.utils._pytree.tree_leaves(stm), torch.utils._pytree.tree_leaves(st1))])
    spt, times, _ = streaming.scan_forward(rt, xs, 2048, backend="fused", mesh=mesh, with_time=True)
    out["scan_times"] = times.numpy()
    out["scan_times_one"] = streaming.scan_forward(rt, xs, 2048, with_time=True)[1].numpy()
    g = lambda: torch.Generator().manual_seed(3)
    for mode in ("random", "pghi"):
        out["scan_roundtrip_" + mode] = rec("scan_roundtrip_" + mode, lambda: streaming.scan_roundtrip(
            rt, xs, 2048, mode, generator=g(), backend="fused", mesh=mesh)).full_tensor().numpy()
        out["scan_roundtrip_one_" + mode] = streaming.scan_roundtrip(rt, xs, 2048, mode, generator=g(),
                                                                     backend="fused").numpy()
    mags = sp1.abs()
    out["scan_invert_random"] = rec("scan_invert_random", lambda: streaming.scan_invert(
        rt, mags, 16, "random", generator=g(), backend="fused", mesh=mesh)).full_tensor().numpy()
    out["scan_invert_one_random"] = streaming.scan_invert(rt, mags, 16, "random", generator=g(),
                                                          backend="fused").numpy()
    out["scan_invert_complex"] = streaming.scan_invert(rt, sp1, 16, backend="fused", mesh=mesh).full_tensor().numpy()
    out["scan_invert_one_complex"] = streaming.scan_invert(rt, sp1, 16, backend="fused").numpy()
    out["scan_err_rank1"] = np.array(_err(lambda: streaming.scan_forward(rt, xs[0], 2048, mesh=mesh)))
    out["scan_err_unbatched"] = np.array(_err(lambda: streaming.scan_invert(rt, mags[0], 16, "pghi", mesh=mesh)))

    # ---- serving: the bucketed server and the live session
    st_t = T.STFT(n_fft=N_FFT, hop_length=HOP, device=D)
    s0 = CompiledTransform(st_t, buckets=(8192,), batch_sizes=(4, 8))
    sm = CompiledTransform(st_t, buckets=(8192,), batch_sizes=(4, 8), mesh=mesh)
    xv = inp["x_serve"]
    ym = rec("serve_forward", lambda: sm.forward(xv))
    y0 = s0.forward(xv)
    out["serve_forward"], out["serve_forward_one"] = ym.full_tensor().numpy(), y0.numpy()
    rm = rec("serve_invert", lambda: sm.invert(ym))
    out["serve_invert"], out["serve_invert_one"] = rm.full_tensor().numpy(), s0.invert(y0).numpy()
    short = rec("serve_short", lambda: sm.forward(xv[:3]))
    out["serve_short"] = short.full_tensor().numpy()
    out["serve_err"] = np.array(_err(lambda: CompiledTransform(st_t, batch_sizes=(2, 4), mesh=mesh)))
    mag_chain = T.STFT(n_fft=N_FFT, hop_length=HOP, device=D) + T.Magnitude(mode="unipolar", mel=False,
                                                                         n_fft=N_FFT, device=D)
    mag_chain = mag_chain.fit(xv)
    smm = CompiledTransform(mag_chain, buckets=(8192,), batch_sizes=(8,), mesh=mesh)
    out["serve_phaseless"] = smm.invert(smm.forward(xv)).full_tensor().numpy()

    s_chain = T.OverlapAdd(N_FFT, HOP, device=D) + T.RealtimeSTFT(n_fft=N_FFT, hop_length=HOP,
                                                                 inversion_mode="random", device=D)
    xx = inp["x_sess"]
    ss0 = StreamingSession(s_chain, 1024, batch_shape=(8,), inversion_mode="random")
    ssm = StreamingSession(s_chain, 1024, batch_shape=(8,), inversion_mode="random", mesh=mesh)
    enc, dec = [], []
    with record_collectives() as r:
        for i in range(2):
            f = ssm.encode(xx[:, i * 1024:(i + 1) * 1024])
            enc.append(f)
            dec.append(ssm.decode(f.abs()))
    records["session"] = r
    out["session_encode"] = np.stack([f.full_tensor().numpy() for f in enc])
    out["session_encode_one"] = np.stack([ss0.encode(xx[:, i * 1024:(i + 1) * 1024]).numpy() for i in range(2)])
    out["session_decode"] = np.stack([d.full_tensor().numpy() for d in dec])
    out["session_err"] = np.array(_err(lambda: StreamingSession(s_chain, 1024, inversion_mode="random", mesh=mesh)))

    # ---- shard_map_batch edge cases
    out["smb_err_divisible"] = np.array(_err(lambda: shard_map_batch(lambda v: v, mesh)(torch.zeros(3, 8))))
    out["smb_err_rank1"] = np.array(_err(lambda: shard_map_batch(lambda v: v, mesh)(torch.zeros(1024))))
    xb = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    y, table = shard_map_batch(lambda v: (v * 2.0, torch.ones(1, 3)), mesh)(xb)
    out["smb_lead1_y"], out["smb_lead1_table"] = y.full_tensor().numpy(), table.full_tensor().numpy()
    out["smb_lead1_table_placements"] = np.array(str(table.placements))
    keyed = shard_map_batch(lambda v, gen: v + torch.randn(v.shape, generator=gen), mesh, keyed=True)
    out["smb_keyed"] = keyed(torch.zeros(4, 16), torch.Generator().manual_seed(0)).full_tensor().numpy()
    out["smb_keyed_again"] = keyed(torch.zeros(4, 16), torch.Generator().manual_seed(0)).full_tensor().numpy()

    # ---- a planted batch-shaped all-reduce, and a scalar one
    def bad(v):
        dist.all_reduce(v, group=mesh.get_group("data"))
        return v

    rec("planted_batch", lambda: shard_map_batch(bad, mesh)(torch.ones(8, 128)))
    rec("planted_scalar", lambda: dist.all_reduce(torch.ones(()), group=mesh.get_group("data")))

    # ---- the sharded export
    e_chain = (T.STFT(n_fft=256, hop_length=64, device=D) + T.Magnitude(mode="unipolar", mel=True, n_fft=256,
                                                                       device=D))
    xe = inp["x_export"]
    e_chain = e_chain.fit(xe)
    fused = fuse.fuse_forward(e_chain, backend="kernel")
    path = os.path.join(out_dir, "sharded.pt2")
    if rank == 0:
        export.export_program(fused, (xe,), path=path, in_shardings=mesh)
    dist.barrier()
    prog = export.load_program(path)
    ye = rec("export", lambda: prog(xe))
    out["export"], out["export_one"] = ye.full_tensor().numpy(), fused(xe).numpy()
    out["export_nodes"] = np.array([str(n.target) for n in prog.graph.nodes if n.op == "call_function"])
    out["export_sharding"] = np.array(json.dumps(prog.sharding))
    out["export_err"] = np.array(_err(lambda: export.export_program(fused, (xe,), in_shardings=mesh,
                                                                    polymorphic_batch=True)))


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    try:
        out, records = {}, {}
        scenarios(out, records, out_dir)
        out["records"] = np.array(json.dumps(records))
        np.savez(os.path.join(out_dir, "rank%d.npz" % rank), **out)
    finally:
        dist.destroy_process_group()
