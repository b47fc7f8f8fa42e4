"""Times the halo exchange's transport against point-to-point sends.

    python3 halo_transport.py [--ranks N] [--calls C] [--device cpu]

Spawns ``N`` ranks (default: one per card, or two on a single card or on
the CPU) on a ``1 x N`` mesh and exchanges a (2, 2)-row halo of this rank's
slab of a bf16 ``[8, 64, 64, 1024]`` activation (the res2 stack's at patch
128, batch 8) ``C`` times each way:

- ``pairs``: ``ops/halo.py``'s exchange, an all-gather within each pair
  of neighbouring ranks (what the port runs);
- ``p2p``: ``dist.batch_isend_irecv`` of the same rows to and from the
  two neighbours.

Each rank checks the extended slab against the zero-padded whole tensor
and reports ms per exchange (CUDA events on a card, the host clock on the
CPU) and the halo bytes it received per exchange, or the error its
transport raised. NCCL is the backend where every
rank has its own card, gloo where ranks share one or run on the CPU. The
transports run in separate launches, so that a transport that kills its
ranks leaves the other's result standing. Prints one JSON line per
transport, then the card's ``nvidia-smi`` name and power limit; exits 1
when the port's transport fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SHAPE = (8, 64, 64, 1024)
HALO = (2, 2)


def _p2p_exchange(x, lo, hi, shard):
    """The rows ``exchange`` returns, moved by point-to-point ops on the
    world group (the mesh is 1 x N, so model index = rank)."""
    import torch
    import torch.distributed as dist

    h, r = x.shape[1], shard.index
    top = x.new_zeros((x.shape[0], lo) + tuple(x.shape[2:]))
    bottom = x.new_zeros((x.shape[0], hi) + tuple(x.shape[2:]))
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, x.narrow(1, 0, hi).contiguous(), r - 1),
                dist.P2POp(dist.irecv, top, r - 1)]
    if r + 1 < shard.size:
        ops += [dist.P2POp(dist.isend, x.narrow(1, h - lo, lo).contiguous(), r + 1),
                dist.P2POp(dist.irecv, bottom, r + 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([top, x, bottom], dim=1)


def _rank(rank: int, n: int, transport: str, calls: int, device: str, tmp: str) -> None:
    import torch

    from rendernet_tpu_torch.ops import halo
    from rendernet_tpu_torch.train import distributed

    distributed.initialize_multihost(f"file://{tmp}/init_{transport}", n, rank,
                                     device=device or None)
    out = {"rank": rank, "transport": transport, "backend": torch.distributed.get_backend()}
    try:
        mesh = distributed.make_mesh(n_data=1, n_model=n, device=device or None)
        shard = distributed.spatial_sharding(mesh, 4)
        dev = mesh.device
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(SHAPE, generator=gen, device=dev).to(torch.bfloat16)
        lo, hi = HALO
        mine = shard.take(x).contiguous()
        r0, r1 = shard.rows(SHAPE[1])
        want = halo.pad_rows(x, lo, hi, 1).narrow(1, r0, r1 - r0 + lo + hi)
        if transport == "pairs":
            fn = lambda: halo.exchange(mine, lo, hi, shard, 1)  # noqa: E731
        else:
            fn = lambda: _p2p_exchange(mine, lo, hi, shard)  # noqa: E731
        try:
            with torch.no_grad():
                out["equal"] = bool(torch.equal(fn(), want))
                cuda = dev.type == "cuda"
                if cuda:
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                for _ in range(calls):  # a fixed count: every rank exchanges alike
                    fn()
                if cuda:
                    end.record()
                    end.synchronize()
                    out["ms"] = start.elapsed_time(end) / calls
                else:
                    out["ms"] = (time.perf_counter() - t0) * 1e3 / calls
            rows = (lo if shard.index > 0 else 0) + (hi if shard.index + 1 < n else 0)
            out["received_bytes"] = rows * mine[:, :1].numel() * mine.element_size()
        except Exception as e:  # the transport's own failure is the reading
            out["error"] = repr(e)[:500]
    finally:
        with open(os.path.join(tmp, f"{transport}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    import torch

    from rendernet_tpu_torch.train import distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--device", default="", help="'cpu' for the CPU (default: the cards)")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if args.device != "cpu" else 0
    n = args.ranks or max(cards, 2)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for transport in ("pairs", "p2p"):
            res = {"transport": transport, "ranks": n, "shape": list(SHAPE), "halo": list(HALO)}
            try:
                distributed.launch(_rank, n, (n, transport, args.calls, args.device, tmp),
                                   timeout=300)
            except Exception as e:  # the ranks' files say what they got to
                res["launch_error"] = repr(e)[:500]
            res["per_rank"] = []
            for r in range(n):
                path = os.path.join(tmp, f"{transport}_rank{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        res["per_rank"].append(json.load(f))
            good = (len(res["per_rank"]) == n and "launch_error" not in res
                    and all(p.get("equal") for p in res["per_rank"]))
            res["ok"] = good
            if transport == "pairs":
                ok = ok and good
            print(json.dumps(res), flush=True)
    if cards:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
