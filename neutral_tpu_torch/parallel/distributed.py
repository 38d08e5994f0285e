"""Runs over several processes: the process group and the collectives that
the decomposed loop needs (port of `neutral_tpu/parallel/sharding.py`'s
`initialise_distributed` and of the JAX package's gathers across
processes, `parallel/common.py:59-72` and `io_utils.py:45`).

A run of N global shards over W processes gives process r the shards
[r*N/W, (r+1)*N/W) (`local_shards`); the shards, their lanes and the
launches that drive them stay where they are, and only host arrays cross
between processes:

* `all_gather_rows`: every process's block of counter rows, once per
  chunk, so that every process holds the same global counters and takes
  the same decisions (and so makes the same collective calls);
* `exchange`: one buffer of packed lanes for every other process, sized
  from those counters (no size handshake);
* `all_gather_arrays`: host arrays of any length from every process (the
  tallies and states that checkpoints, dumps and validation read).  Like
  JAX's `process_allgather` it gives every process the whole value, so
  every process's run returns the same tally; process 0 alone writes
  files.

The backend is gloo, over tensors staged on the host, on every device:
the loop reads its counters to the host once per chunk anyway, and NCCL
refuses two ranks on one card.  Every call here is a collective: every
process makes it at the same point of the run, or the others wait until
the process group's timeout and raise.  Nothing falls back to a single
process.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

BACKEND = "gloo"
TIMEOUT = datetime.timedelta(minutes=5)


def initialise_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join this process to the run's process group (gloo).

    With `coordinator` ("HOST:PORT", where process 0 listens) the
    rendezvous is explicit and needs `num_processes` and `process_id`;
    any failure raises.  Without it the group comes from the environment
    that `torchrun` sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE;
    `num_processes` and `process_id` override the last two), and with no
    WORLD_SIZE or a WORLD_SIZE of 1 this is a no-op: a single process.
    A process already in a group stays in it.  `timeout` bounds the
    rendezvous and every later collective."""
    if dist.is_initialized():
        return
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        dist.init_process_group(BACKEND, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
        return
    size = (num_processes if num_processes is not None
            else int(os.environ.get("WORLD_SIZE", "1")))
    if size <= 1:
        return
    rank_ = (process_id if process_id is not None
             else int(os.environ["RANK"]))
    dist.init_process_group(BACKEND, init_method="env://", world_size=size,
                            rank=rank_, timeout=timeout)


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of processes of the run (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_shards(nshards: int) -> range:
    """The global shards that this process owns: a contiguous block of
    nshards / world; raises unless world divides nshards."""
    w = world()
    if nshards % w:
        raise ValueError(f"{nshards} shards cannot be split evenly over "
                         f"{w} processes")
    per = nshards // w
    return range(rank() * per, (rank() + 1) * per)


def process_of(shard: int, nshards: int) -> int:
    """The rank of the process that owns global shard `shard`."""
    return shard // (nshards // world())


def all_gather_rows(block: np.ndarray) -> np.ndarray:
    """Every process's (k, m) int64 block, stacked in rank order: (W*k, m).
    Every process passes a block of the same shape."""
    if world() == 1:
        return block
    t = torch.from_numpy(np.ascontiguousarray(block, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t)
    return torch.cat(out).numpy()


def all_gather_arrays(arrays: list[np.ndarray]) -> list[np.ndarray]:
    """Every process's `arrays` (1-d host arrays: the same count and
    dtypes on every process, any lengths), concatenated in rank order."""
    if world() == 1:
        return list(arrays)
    sizes = torch.tensor([a.nbytes for a in arrays], dtype=torch.int64)
    all_sizes = [torch.empty_like(sizes) for _ in range(world())]
    dist.all_gather(all_sizes, sizes)
    width = max(int(s.sum()) for s in all_sizes)
    buf = torch.zeros(width, dtype=torch.uint8)
    off = 0
    for a in arrays:
        buf[off:off + a.nbytes] = torch.from_numpy(
            np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        off += a.nbytes
    out = [torch.empty_like(buf) for _ in range(world())]
    dist.all_gather(out, buf)
    result = []
    for s, b in zip(all_sizes, out):
        off, b = 0, b.numpy()
        for a, nbytes in zip(arrays, s.tolist()):
            result.append(b[off:off + nbytes].view(a.dtype).copy())
            off += nbytes
    return result


def exchange(send: list[torch.Tensor], recv_bytes: list[int]
             ) -> list[torch.Tensor]:
    """Send send[p] (a 1-d uint8 host tensor) to process p and receive
    recv_bytes[p] bytes from it, for every p; returns the received
    buffers, in rank order.  The entries for this process are empty."""
    inp = torch.cat(send)
    out = torch.empty(sum(recv_bytes), dtype=torch.uint8)
    dist.all_to_all_single(out, inp, output_split_sizes=list(recv_bytes),
                           input_split_sizes=[s.numel() for s in send])
    return list(torch.split(out, list(recv_bytes)))
