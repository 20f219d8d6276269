"""Probe: NCCL collectives of a one-rank process group inside a CUDA graph.

    python3 tools/nccl_capture_probe.py

Starts a one-rank NCCL group on an in-process store (no network), runs an
eager ``all_reduce`` (MIN on float32, SUM on int32) and an all-gather, then
captures 100 rounds of (an add, two in-place all-reduces, one all-gather)
in one CUDA graph, replays it, prints the device µs per round (CUDA events
over 10 replays), the eager µs per all-reduce, and the profiler's kernels
of one replay. Exits nonzero where a collective or the capture fails. Needs
one NVIDIA GPU.
"""
import sys
import time

import torch
import torch.distributed as dist


def main() -> int:
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    print("init", time.time() - t0, dist.get_backend(), dist.group.WORLD.size())
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    x = torch.arange(4, dtype=torch.float32, device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MIN)
    i = torch.tensor([3, 1], dtype=torch.int32, device=dev)
    dist.all_reduce(i, op=dist.ReduceOp.SUM)
    gather(torch.empty(4, device=dev), x)
    torch.cuda.synchronize()
    print("eager collectives ok", x.tolist(), i.tolist())

    y = torch.zeros(230, device=dev)
    z = torch.zeros(4, dtype=torch.int32, device=dev)
    out = torch.empty(230, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            y.add_(1.0)
            dist.all_reduce(y, op=dist.ReduceOp.MIN)
            dist.all_reduce(z)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(100):
            y.add_(1.0)
            dist.all_reduce(y, op=dist.ReduceOp.MIN)
            dist.all_reduce(z, op=dist.ReduceOp.SUM)
            gather(out, y)
    y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert y[0].item() == 100.0 and out[0].item() == 100.0, "the replay computed other values"
    print("capture and replay ok")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        graph.replay()
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    print("device us per (add + 2 all-reduces + all-gather):",
          start.elapsed_time(end) * 1000 / 1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(y, op=dist.ReduceOp.MIN)
    torch.cuda.synchronize()
    print("eager us per all-reduce", (time.perf_counter() - t0) / 200 * 1e6)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    print(prof.key_averages().table(row_limit=8))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("nccl_capture_probe: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
