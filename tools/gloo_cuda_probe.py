"""Which collectives a gloo group carries for CUDA tensors, on this
machine's torch: two spawned ranks on one card (a gloo group on a
``FileStore``, as two ranks sharing a card run) try each collective that
``repro_torch.parallel.tensor`` uses (and the ZeRO-1 reduce-scatter of
``launch.steps``), in fp32 and bf16, and check the result against the
sum, max, stack or block computed on the host:

    PYTHONPATH=src python3 tools/gloo_cuda_probe.py

Prints the card's name and power limit, torch's and CUDA's versions, then
one JSON line: each collective and dtype, "ok" or the error's first line.
``parallel.tensor.GLOO_CUDA`` lists what it carries; anything else is
staged through host memory there.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import tempfile

import torch
import torch.distributed as dist

from repro_torch.compat import all_gather_single, reduce_scatter_single

CASES = ("all_reduce_sum", "all_reduce_max", "all_gather", "reduce_scatter")


def _rank(rank: int, world: int, store: str, out) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    got = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name in CASES:
            x = (torch.arange(6, device="cuda") + 10 * rank).to(dtype)
            want = [torch.arange(6) + 10 * r for r in range(world)]
            try:              # the probe's question: does gloo carry it?
                if name == "all_gather":
                    y = x.new_empty(world * 6)
                    all_gather_single(y, x)
                    ok = torch.equal(y.cpu().float(), torch.cat(want).float())
                elif name == "reduce_scatter":
                    y = x.new_empty(6 // world)
                    reduce_scatter_single(y, x)
                    ok = torch.equal(y.cpu().float(), sum(want).float().chunk(
                        world)[rank])
                else:
                    op = dist.ReduceOp.SUM if name.endswith("sum") else \
                        dist.ReduceOp.MAX
                    dist.all_reduce(x, op=op)
                    ref = sum(want) if op == dist.ReduceOp.SUM else want[-1]
                    ok = torch.equal(x.cpu().float(), ref.float())
                got[f"{name} {str(dtype)[6:]}"] = "ok" if ok else "wrong"
            except Exception as e:                      # noqa: BLE001
                got[f"{name} {str(dtype)[6:]}"] = str(e).splitlines()[0]
    out.put((rank, got))
    dist.destroy_process_group()


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, 2, store, out))
                 for r in range(2)]
        for p in procs:
            p.start()
        res = dict(out.get(timeout=120) for _ in procs)
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    print(json.dumps({"gloo_cuda": res}))


if __name__ == "__main__":
    main()
