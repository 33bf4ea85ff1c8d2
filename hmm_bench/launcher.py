"""One process per rank for a cell whose traffic asks for ``ranks`` > 1.

The parent starts ``ranks`` copies of the same command with RANK,
LOCAL_RANK, WORLD_SIZE and the rendezvous (127.0.0.1 and a free port)
in their environment, waits for every one and returns the worst exit
code; each rank takes the card of its LOCAL_RANK, and only rank 0
prints a result.

    python -m hmm_bench.launcher --probe 2    # a gloo all_reduce over 2 ranks
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: list, ranks: int, timeout: float | None = None) -> int:
    """Run ``argv`` once per rank and wait for all of them; the worst exit
    code (a rank that is still running at ``timeout`` is killed)."""
    port = free_port()
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(ranks),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(argv, env=env))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(codes, key=abs) if codes else 1


def init_rank(device_type: str):
    """This process's rank in the default group (NCCL on the cards, gloo on
    the CPU) and its device; (0, 1) without the launcher's environment."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1, None
    rank = int(os.environ["RANK"])
    dev = None
    if device_type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                                        f"{os.environ['MASTER_PORT']}",
                            world_size=world, rank=rank)
    return rank, world, dev


def _probe() -> int:
    import torch
    import torch.distributed as dist

    rank, world, _ = init_rank("cpu")
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    if rank == 0:
        print(f"world {world} sum {float(x[0]):g}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--probe":
        if "RANK" in os.environ:
            sys.exit(_probe())
        sys.exit(spawn([sys.executable, "-m", "hmm_bench.launcher", "--probe", sys.argv[2]],
                       int(sys.argv[2]), timeout=120))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
