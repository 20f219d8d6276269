"""One rank of ``tests/test_torch_server_axis.py``'s process groups.

The JAX server-axis probe's inputs (``tests/test_sharding_servers.py``:
T = 23 grid types, m = 8 servers, 24 arrivals, a 4-segment fused loop with
the fleet controller, metrics and the decision recorder) and the standalone
sharded entries' inputs, made with numpy from a seed, then run through the
port's entry points on a ``ServerAxis``. Imports only the port.

    python tests/_torch_shard_ranks.py RANK WORLD DIR

joins a gloo group of WORLD ranks on a ``FileStore`` in DIR, runs every
entry on the sharded axis and writes the outputs to ``DIR/rank<RANK>.npz``.
The test process calls :func:`run_entries` with the dense axis for the
reference.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from repro_torch.core import M1, M2, PackedCluster, PackedDynamics, run_trace
from repro_torch.core import greedy_sequence_hier, greedy_sequence_sharded
from repro_torch.core.closed_loop import (ClosedLoopConfig, LoopCarry, SegmentIn,
                                          run_closed_loop, stack_outputs)
from repro_torch.distributed import ServerAxis
from repro_torch.fleet import CusumState, cusum_update_sharded, resolve_leaders_device
from repro_torch.fleet.pool import shard_local_pools
from repro_torch.obs import metrics as OM
from repro_torch.obs import recorder as OR
from repro_torch.telemetry.estimator import DeviceEstimatorState, bank_update_sharded
from repro_torch.telemetry.log import RingBlock

T, M, N = 23, 8, 24
N_SEG, S_CAP, RING_CAP = 4, 4, 256
#: the standalone estimator / detector block, and the fused loop's config
B = 48
BANK_HYPERS = dict(lr=0.6, decay=0.997, step_damp=0.5, solo_eps=0.05, max_lost_frac=0.5,
                   scatter="torch", sparse_tables=True)
CUSUM_HYPERS = dict(k=0.25, level_decay=0.9, max_lost_frac=0.5)
CONFIG = dict(fleet=True, metrics=True, record=True, warmup_segments=1, cusum_h=0.5,
              scatter="torch")
#: the pods of the hierarchical greedy (a multiple of every world size run)
PODS = 4


def probe_arrays(seed: int = 7) -> dict:
    """The JAX probe's draws, in its order, plus the standalone entries'."""
    rng = np.random.default_rng(seed)
    servers = [dataclasses.replace([M1, M2][i % 2], name=f"s{i}") for i in range(M)]
    c0 = PackedCluster.build(servers, [np.full((230, 230), 0.05, np.float32)] * M, alpha=1.3,
                             device="cpu")
    a = dict(
        D=rng.uniform(0, 0.1, (M, T, T)).astype(np.float32), rs=c0.rs[:T].numpy(),
        fs=c0.fs[:T].numpy(), llc_budget=c0.llc_budget.numpy(),
        resident=c0.resident[:, :T].numpy(), active=c0.active.numpy())
    logd = rng.uniform(-0.2, -0.01, (M, T, T)).astype(np.float32)
    a.update(solo=rng.uniform(5e5, 2e6, (M, T)).astype(np.float32),
             base_lost=rng.uniform(1e5, 5e5, (M, T)).astype(np.float32),
             log_keep=logd, log_lost=logd * 2.0,
             comp_bytes=rng.uniform(5e4, 2e5, (M, T)).astype(np.float32),
             tol_budget=rng.uniform(5e6, 2e7, (M,)).astype(np.float32))
    a.update(arr_time=np.sort(rng.uniform(0, 2, N)).astype(np.float32),
             arr_type=rng.integers(0, T, N).astype(np.int32),
             arr_bytes=rng.uniform(2e5, 2e6, N).astype(np.float32))
    a.update(x_time=np.sort(rng.uniform(0, 2, (S_CAP, N_SEG)), axis=1).astype(np.float32),
             x_type=rng.integers(0, T, (S_CAP, N_SEG)).astype(np.int32),
             x_bytes=rng.uniform(2e5, 2e6, (S_CAP, N_SEG)).astype(np.float32))
    a["logb"] = np.log(rng.uniform(5e5, 2e6, (M, T))).astype(np.float32)
    a["row_map"] = (np.arange(M) // 2 * 2).astype(np.int32)
    # the standalone entries: a greedy sequence, a bank, an observation block
    ext = np.random.default_rng(seed + 1)
    a["g_types"] = ext.integers(0, T, 32).astype(np.int32)
    a.update(b_L_t=ext.normal(-0.05, 0.02, (M, T, T)).astype(np.float32),
             b_log_b=ext.normal(13.0, 0.3, (M, T)).astype(np.float32),
             b_n_pair_t=ext.uniform(0, 3, (M, T, T)).astype(np.float32),
             b_n_base=ext.uniform(0, 3, (M, T)).astype(np.float32),
             b_n_obs=ext.integers(0, 5, M).astype(np.int32))
    co = ext.integers(0, 3, (B, T)).astype(np.float32) * (ext.uniform(size=(B, 1)) < 0.7)
    a.update(k_wtype=ext.integers(0, T, B).astype(np.int32),
             k_server=ext.integers(-1, M, B).astype(np.int32),
             k_duration=ext.uniform(0.1, 2.0, B).astype(np.float32),
             k_y=ext.normal(13.0, 0.5, B).astype(np.float32), k_co=co,
             k_lost=ext.uniform(0, 1, B).astype(np.float32), k_valid=ext.uniform(size=B) < 0.9)
    a["pool_labels"] = ext.integers(0, 3, M).astype(np.int64)
    return a


def cluster_dyn(a: dict, device="cpu") -> tuple[PackedCluster, PackedDynamics]:
    t = lambda k: torch.from_numpy(a[k]).to(device)  # noqa: E731
    cluster = PackedCluster(D=t("D"), rs=t("rs"), fs=t("fs"), llc_budget=t("llc_budget"),
                            resident=t("resident"), active=t("active"))
    dyn = PackedDynamics(*(t(k) for k in ("solo", "base_lost", "log_keep", "log_lost",
                                          "comp_bytes", "tol_budget")))
    return cluster, dyn


def closed_loop_inputs(a: dict, device="cpu"):
    """(carry0, xs, Lp_t, logb): the probe's fused-loop inputs (a zero bank,
    pairs of servers pooled, a fresh ring and decision ring)."""
    f32, i32 = dict(dtype=torch.float32, device=device), dict(dtype=torch.int32, device=device)
    bank = DeviceEstimatorState(
        L_t=torch.zeros((M, T, T), **f32), log_b=torch.zeros((M, T), **f32),
        n_pair_t=torch.zeros((M, T, T), **f32), n_base=torch.zeros((M, T), **f32),
        n_obs=torch.zeros((M,), **i32))
    ring = RingBlock(ints=torch.full((RING_CAP, 2), -1, **i32),
                     scalars=torch.zeros((RING_CAP, 6), **f32),
                     co=torch.zeros((RING_CAP, T), **f32))
    row_map = torch.from_numpy(a["row_map"]).to(device)
    carry0 = LoopCarry(
        bank=bank, det=CusumState.zeros(M, device=device), row_map=row_map,
        read_row=row_map.clone(), active=torch.ones(M, dtype=torch.bool, device=device),
        seen=torch.zeros((), **i32), req_type=torch.zeros(N_SEG, **i32),
        req_bytes=torch.ones(N_SEG, **f32), req_n=torch.zeros((), **i32), ring=ring,
        ring_ptr=torch.zeros((), **i32), ring_total=torch.zeros((), **i32),
        metrics=OM.zeros(M, device), rec=OR.init(64, device))
    xs = SegmentIn(arr_time=torch.from_numpy(a["x_time"]).to(device),
                   arr_type=torch.from_numpy(a["x_type"]).to(device),
                   arr_bytes=torch.from_numpy(a["x_bytes"]).to(device),
                   dyn_idx=np.zeros(S_CAP, np.int64),
                   seg_valid=torch.ones(S_CAP, dtype=torch.bool, device=device))
    Lp_t = torch.full((M, T, T), float(np.float32(np.log1p(-0.05))), dtype=torch.float64,
                      device=device)
    return carry0, xs, Lp_t, torch.from_numpy(a["logb"]).to(device)


def obs_block(a: dict, device="cpu") -> RingBlock:
    return RingBlock.build(*(torch.from_numpy(a[k]).to(device) for k in (
        "k_wtype", "k_server", "k_duration", "k_y", "k_co", "k_lost", "k_valid")))


def leader_rows(labels) -> np.ndarray:
    """The host constructor's rule: each server reads its pool's lowest
    member (``PooledEstimatorBank.row_of``)."""
    leader: dict = {}
    return np.asarray([leader.setdefault(lab, s) for s, lab in enumerate(labels)], np.int32)


def _flat(prefix: str, tree, out: dict) -> None:
    if torch.is_tensor(tree):
        out[prefix] = tree.detach().cpu().numpy()
    elif isinstance(tree, np.ndarray):
        out[prefix] = tree
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            _flat(f"{prefix}.{name}", getattr(tree, name), out)


def run_entries(axis: ServerAxis | None, a: dict, shards: int = 1) -> dict:
    """Every sharded entry point on ``axis`` (None: dense), flattened to
    numpy arrays by name. ``shards`` namespaces the leader-election pools."""
    torch.manual_seed(0)
    cluster, dyn = cluster_dyn(a)
    t = lambda k: torch.from_numpy(a[k])  # noqa: E731
    out: dict = {}
    rt = run_trace(cluster, dyn, t("arr_time"), t("arr_type"), t("arr_bytes"), telemetry=True,
                   metrics=True, record=True, axis=axis)
    for f in ("placement", "was_queued", "place_time", "finish_time", "makespan", "max_deg",
              "deadlock", "obs_co", "obs_lost", "obs_logr"):
        out[f"rt.{f}"] = getattr(rt, f).numpy()
    _flat("rt.metrics", rt.metrics, out)
    _flat("rt.rec", rt.rec, out)
    out["rt.stats"] = np.asarray([rt.stats.events, rt.stats.host_syncs,
                                  rt.stats.drain_full_scans])

    carry0, xs, Lp_t, logb = closed_loop_inputs(a)
    config = ClosedLoopConfig(axis=axis, **CONFIG)
    final, outs = run_closed_loop(cluster, [dyn], Lp_t, logb, carry0, xs, config)
    ys, _ = stack_outputs(outs)
    _flat("cl", final, out)
    _flat("ys", ys, out)

    dense_axis = ServerAxis() if axis is None else axis
    counts0 = torch.zeros((M, T))
    c, p = greedy_sequence_sharded(cluster, counts0, t("g_types"), dense_axis)
    out["g.counts"], out["g.placement"] = c.numpy(), p.numpy()
    hier = dataclasses.replace(dense_axis, pods=PODS)
    c, p = greedy_sequence_hier(cluster, counts0, t("g_types"), hier)
    out["h.counts"], out["h.placement"] = c.numpy(), p.numpy()

    bank = DeviceEstimatorState(*(t(f"b_{k}") for k in DeviceEstimatorState._fields))
    block = obs_block(a)
    new, used = bank_update_sharded(dense_axis, bank, block, **BANK_HYPERS)
    _flat("bank", new, out)
    out["bank.used"] = used.numpy()
    det = CusumState(*(torch.full_like(x, 0.25) for x in CusumState.zeros(M, device="cpu")))
    new, used = cusum_update_sharded(dense_axis, det, block, bank.log_b, bank.L_t,
                                     t("row_map"), **CUSUM_HYPERS)
    _flat("cusum", new, out)
    out["cusum.used"] = used.numpy()
    labels = shard_local_pools(list(a["pool_labels"]), M, shards)
    ids = {lab: i for i, lab in enumerate(dict.fromkeys(labels))}
    pool_ids = torch.tensor([ids[lab] for lab in labels], dtype=torch.int32)
    pool_ids[M - 1] = -1  # a dropped server
    out["leaders"] = resolve_leaders_device(dense_axis, pool_ids).numpy()
    return out


def main(rank: int, world: int, where: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(where, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        axis = ServerAxis.over_process_group(device="cpu")
        assert axis.shards == world and axis.is_sharded
        out = run_entries(axis, probe_arrays(), shards=world)
        np.savez(os.path.join(where, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
