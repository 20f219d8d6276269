"""Quickstart on the PyTorch port: the paper's consolidation pipeline end to end.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

The twin of ``examples/quickstart.py`` on ``repro_torch``, which imports
nothing of JAX:

1. profile pairwise degradations D_{i,j} on the Table-I servers (the 52_900-
   run experiment of §VIII, vectorized);
2. pack an arriving workload sequence with the greedy of Fig 8 -- the
   float64 oracle, and the same greedy on the device, which must agree;
3. verify the two §V criteria hold and compare against brute-force optimal;
4. calibrate alpha (§V's TDP ratio, Fig 9's sweep) and refine the packing by
   local search, on the host and on the device.

The device parts run on the card unless ``--device cpu`` is given; without a
card the script refuses to run.
"""
import argparse

import torch

from repro_torch.core import (
    M1,
    PAPER_CLUSTER,
    ClusterState,
    PackedCluster,
    average_min_throughput_simulated,
    brute_force,
    calibrate_alpha,
    counts_from_assignments,
    local_search,
    local_search_engine,
    parse_workloads,
    pick_alpha,
    profile_pairwise_fast,
    snap_to_grid,
    sweep_alpha,
    type_index,
)
from repro_torch.core import greedy_sequence as device_greedy_sequence
from repro_torch.core.binpack import greedy_sequence  # the float64 oracle's greedy
from repro_torch.device import resolve_device

INITIAL = [
    "(32KB, 64KB), (4KB, 16KB), (16KB, 32MB)",
    "(32KB, 64MB), (512KB, 2MB), (128KB, 512KB)",
    "(256KB, 1MB), (4KB, 2MB), (32KB, 8MB)",
    "(2KB, 32KB), (512KB, 64MB), (8KB, 4MB)",
]
ARRIVALS = "(16KB, 64KB), (32KB, 1MB), (64KB, 64MB), (32KB, 2MB), (8KB, 64MB)"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    # 1. profile the testbed (simulator stands in for TestDFSIO runs)
    servers = list(PAPER_CLUSTER)
    D = [profile_pairwise_fast(s) for s in servers]
    print(f"profiled D matrices: {len(D)} servers x {D[0].shape} types")

    # 2. initial state + arrivals (paper Table III, sequence 1)
    initial = [[snap_to_grid(w) for w in parse_workloads(txt)] for txt in INITIAL]
    state = ClusterState.empty(servers, D, alpha=1.3)
    for i, ws in enumerate(initial):
        state.assignments[i] = list(ws)
    arrivals = [snap_to_grid(w) for w in parse_workloads(ARRIVALS)]

    # the Fig-8 greedy on the device, from the same state (before the oracle
    # mutates it): placements as server indices, -1 where queued
    cluster = PackedCluster.build(servers, D, alpha=1.3, device=device)
    wtypes = torch.tensor([type_index(w) for w in arrivals], dtype=torch.int32, device=device)
    _, dev_place = device_greedy_sequence(cluster, counts_from_assignments(cluster, initial),
                                          wtypes)
    dev_placements = [None if p < 0 else p for p in dev_place.tolist()]

    placements, queued = greedy_sequence(state, arrivals)
    print(f"greedy placements: {placements}  queued: {len(queued)}")
    print(f"device greedy on {device}: {dev_placements}  "
          f"{'agrees' if dev_placements == placements else 'DISAGREES'}")

    # 3. criteria + optimality
    for i, server in enumerate(servers):
        c = state.check(i)
        print(f"  {server.name}: cache_in_use={c.cache_in_use:5.1%} "
              f"max_degradation={c.max_degradation:5.1%} ok={c.ok}")
    print(f"avg min throughput (simulated): {average_min_throughput_simulated(state):.3f}")

    opt_cost, _ = brute_force(ClusterState.empty(servers, D, alpha=1.3), arrivals,
                              allow_queue=True)
    greedy_cost = state.total_avg_load() + len(queued)
    print(f"greedy total load {greedy_cost:.3f} vs fresh-cluster optimal {opt_cost:.3f}")

    # 4. alpha: the TDP calibration on M1 and Fig 9's end-to-end sweep
    alpha_m1 = calibrate_alpha(M1)
    sweep = sweep_alpha(servers, D, initial, arrivals)
    alpha = pick_alpha(sweep)
    print(f"calibrated alpha (M1 TDP ratio): {alpha_m1:.4f}; swept alpha: {alpha} "
          f"({', '.join(f'{a}: {v:.4f}' for a, v in sweep.items())})")

    # local search from the greedy packing, float64 on the host and on the device
    refined, moves = local_search(state)
    refined_dev, moves_dev = local_search_engine(state, device=device)
    print(f"local search: {moves} improvement(s), total load {state.total_avg_load():.4f} -> "
          f"{refined.total_avg_load():.4f}; on {device}: {moves_dev} move(s) -> "
          f"{refined_dev.total_avg_load():.4f}")
    return dict(placements=placements, queued=len(queued), device_placements=dev_placements,
                opt_cost=opt_cost, greedy_cost=greedy_cost, alpha_m1=alpha_m1, sweep=sweep,
                alpha=alpha, moves=moves, refined_load=refined.total_avg_load(),
                moves_device=moves_dev, refined_device_load=refined_dev.total_avg_load())


if __name__ == "__main__":
    main()
