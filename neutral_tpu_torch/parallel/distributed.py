"""Runs over several processes: the process group, the cards each process
drives, and the collectives that the decomposed loop needs (port of
`neutral_tpu/parallel/sharding.py`'s `initialise_distributed` and of the
JAX package's gathers across processes, `parallel/common.py:59-72` and
`io_utils.py:45`).

A run of N global shards over W processes gives process r the shards
[r*N/W, (r+1)*N/W) (`local_shards`), spread in turn over the cards that
process drives (`place_cards`, `shard_devices`).  The shards, their lanes
and the launches that drive them stay where they are; what crosses
between processes:

* `gather_counters`: every process's counter rows, once per chunk, so
  that every process holds the same global counters and takes the same
  decisions (and so makes the same collective calls);
* `exchange`: one buffer of packed lanes for every other process, sized
  from those counters (no size handshake);
* `all_gather_arrays`: tensors of any length from every process (the
  tallies and states that checkpoints, dumps and validation read).  Like
  JAX's `process_allgather` it gives every process the whole value, so
  every process's run returns the same tally; process 0 alone writes
  files.

The backend follows the layout (`pick_backend`): NCCL when the run is on
CUDA and no card serves two processes, each process's collectives on its
first card (rows and lanes of its other cards go there first, one host
read a gather); gloo on the CPU and where processes share a card (NCCL
refuses two ranks on one card), over copies staged on the host.  A failed
NCCL set-up raises: nothing retries with gloo.  Every call here is a
collective: every process makes it at the same point of the run, or the
others wait until the process group's timeout and raise.  Nothing falls
back to a single process.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..census import read_counters

TIMEOUT = datetime.timedelta(minutes=5)
_CARDS_KEY = "neutral_tpu_torch/cards/"


@dataclass
class Layout:
    """The run's process group as every process sees it: its backend, its
    device type and each process's cards (indices as that process numbers
    its visible cards; empty lists on the CPU)."""
    backend: str = "gloo"
    device_type: str = "cpu"
    cards: tuple = ()


_layout = Layout()


def visible_cards() -> list[str]:
    """The UUIDs of the cards this process sees, in its own order."""
    return [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]


def place_cards(process: int, visible: list[list[str]],
                index: int | None = None) -> list[int]:
    """The cards (indices into visible[process]) that `process` drives,
    given every process's visible cards: the one named by `index` when
    the run names one (every process then takes its own card of that
    index), else the processes that see the same cards split them in
    contiguous blocks, in rank order (four processes on four cards take
    one each, two take two each; a process that sees its own cards alone,
    as under CUDA_VISIBLE_DEVICES, takes them all), and where there are
    more such processes than cards they take the cards in turn (several
    processes on one card)."""
    mine = visible[process]
    if index is not None:
        if not 0 <= index < len(mine):
            raise ValueError(f"process {process} was asked for cuda:{index},"
                             f" but sees {len(mine)} card(s)")
        return [index]
    if not mine:
        raise ValueError(f"process {process} sees no card")
    peers = [p for p, v in enumerate(visible) if v == mine]
    i, g, c = peers.index(process), len(peers), len(mine)
    if g > c:
        return [i % c]
    return list(range(i * c // g, (i + 1) * c // g))


def pick_backend(device_type: str, cards: list[list[str]]) -> str:
    """The process group's backend for a run on `device_type` whose
    processes drive `cards` (each process's card UUIDs): nccl when the run
    is on CUDA and no card serves two processes, else gloo."""
    if device_type != "cuda":
        return "gloo"
    owners = [c for mine in cards for c in set(mine)]
    return "nccl" if len(owners) == len(set(owners)) else "gloo"


def initialise_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           timeout: datetime.timedelta = TIMEOUT,
                           device="cpu") -> None:
    """Join this process to the run's process group.

    With `coordinator` ("HOST:PORT", where process 0 listens) the
    rendezvous is explicit and needs `num_processes` and `process_id`;
    any failure raises.  Without it the group comes from the environment
    that `torchrun` sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE;
    `num_processes` and `process_id` override the last two), and with no
    WORLD_SIZE or a WORLD_SIZE of 1 this is a no-op: a single process.
    A process already in a group stays in it.  `timeout` bounds the
    rendezvous and every later collective.

    `device` is the run's device ("cpu", "cuda" or "cuda:K").  On CUDA
    the processes swap their visible cards' UUIDs through the rendezvous
    store, each takes its cards (`place_cards`), the backend follows from
    them (`pick_backend`), and the process's first card becomes its
    current device before the group is made (with NCCL, the
    communicator's set-up is spent here, outside any step)."""
    global _layout
    if dist.is_initialized():
        return
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        url, size, rank_ = f"tcp://{coordinator}", num_processes, process_id
    else:
        size = (num_processes if num_processes is not None
                else int(os.environ.get("WORLD_SIZE", "1")))
        if size <= 1:
            return
        rank_ = (process_id if process_id is not None
                 else int(os.environ["RANK"]))
        url = "env://"
    device = torch.device(device)
    store, rank_, size = next(dist.rendezvous(url, rank_, size,
                                              timeout=timeout))
    store.set_timeout(timeout)
    visible = visible_cards() if device.type == "cuda" else []
    store.set(f"{_CARDS_KEY}{rank_}",
              json.dumps({"visible": visible, "index": device.index}))
    seen = [json.loads(store.get(f"{_CARDS_KEY}{p}")) for p in range(size)]
    cards = ([place_cards(p, [s["visible"] for s in seen], s["index"])
              for p, s in enumerate(seen)] if device.type == "cuda"
             else [[] for _ in seen])
    backend = pick_backend(device.type, [[s["visible"][i] for i in c]
                                         for s, c in zip(seen, cards)])
    first = None
    if device.type == "cuda":
        first = torch.device("cuda", cards[rank_][0])
        torch.cuda.set_device(first)
    dist.init_process_group(
        backend, store=dist.PrefixStore("default_pg", store), rank=rank_,
        world_size=size, timeout=timeout,
        **({"device_id": first} if backend == "nccl" else {}))
    _layout = Layout(backend, device.type, tuple(map(tuple, cards)))
    atexit.register(_leave)
    if backend == "nccl":
        # Each kind of collective the run makes, once: NCCL sets up its
        # rings and its connections between every pair of cards (seconds)
        # at a collective's first call, which would otherwise land in step
        # 1's gather and first exchange.
        warm = torch.zeros(size, dtype=torch.uint8, device=first)
        dist.all_reduce(warm)
        _all_gather(warm)
        dist.all_to_all_single(torch.empty_like(warm), warm)
        torch.cuda.synchronize(first)


def _leave() -> None:
    """At exit, take this process out of the group (which stops NCCL's
    threads before the interpreter's teardown)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of processes of the run (1 outside a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str:
    """The process group's backend ("gloo" outside a process group)."""
    return _layout.backend


def process_cards(process: int | None = None) -> list[torch.device]:
    """The cards that `process` (default: this one) drives, as it numbers
    them; raises unless the group was joined with a CUDA device."""
    if _layout.device_type != "cuda":
        raise ValueError("the process group was joined without a CUDA "
                         "device (initialise_distributed(device=...))")
    return [torch.device("cuda", i)
            for i in _layout.cards[rank() if process is None else process]]


def comm_device() -> torch.device:
    """Where this process's collectives run: its first card under NCCL,
    the host otherwise."""
    if _layout.backend == "nccl" and world() > 1:
        return process_cards()[0]
    return torch.device("cpu")


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


def shard_devices(nshards: int) -> list[torch.device]:
    """The card of every global shard of a run over processes on CUDA:
    each process's block of shards over its cards in turn."""
    local_shards(nshards)
    per = nshards // world()
    out = []
    for s in range(nshards):
        cards = process_cards(s // per)
        out.append(cards[(s % per) % len(cards)])
    return out


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (the same shape everywhere), stacked in rank
    order on t's device."""
    if _layout.backend == "nccl":
        out = t.new_empty((world(), *t.shape))
        dist.all_gather_into_tensor(out, t)
        return out
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t)
    return torch.stack(out)


def gather_counters(rows: list[torch.Tensor], host: np.ndarray
                    ) -> np.ndarray:
    """Every global shard's counters as one (nshards, len + m) int64 host
    array: this process's rows (1-d int64 tensors of one length, one per
    local shard, on the shards' devices) beside its (k, m) int64 `host`
    columns, from every process in rank order.  Alone or under gloo each
    row is read once (census.read_counters) and the block gathered on the
    host; under NCCL the rows are gathered on this process's first card
    and read there, once."""
    dev = comm_device()
    if dev.type == "cuda":
        host = np.asarray(host, dtype=np.int64).reshape(len(rows), -1)
        block = torch.cat([torch.stack([r.to(dev) for r in rows]),
                           torch.from_numpy(host).to(dev)], 1)
        return _all_gather(block).reshape(-1, block.shape[1]).cpu().numpy()
    block = read_counters(rows, host)
    if world() == 1:
        return block
    return _all_gather(torch.from_numpy(block)).reshape(
        -1, block.shape[1]).numpy()


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def all_gather_arrays(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Every process's `tensors` (the same count and dtypes on every
    process, any lengths and devices) as 1-d host arrays, concatenated in
    rank order.  Each process's tensors travel as one byte buffer through
    comm_device(): its first card under NCCL, the host under gloo."""
    if world() == 1:
        return [t.reshape(-1).cpu().numpy() for t in tensors]
    dev = comm_device()
    flat = [t.reshape(-1).to(dev).view(torch.uint8) for t in tensors]
    sizes = torch.tensor([b.numel() for b in flat], dtype=torch.int64,
                         device=dev)
    all_sizes = _all_gather(sizes).cpu().numpy()
    width = int(all_sizes.sum(1).max())
    buf = torch.zeros(width, dtype=torch.uint8, device=dev)
    if flat:
        buf[:int(sizes.sum())] = torch.cat(flat)
    gathered = _all_gather(buf).cpu().numpy()
    dtypes = [_numpy_dtype(t.dtype) for t in tensors]
    result = []
    for b, s in zip(gathered, all_sizes):
        off = 0
        for dtype, nbytes in zip(dtypes, s.tolist()):
            result.append(b[off:off + nbytes].view(dtype).copy())
            off += nbytes
    return result


def exchange(send: list[torch.Tensor], recv_bytes: list[int]
             ) -> list[torch.Tensor]:
    """Send send[p] (a 1-d uint8 tensor, on any device) to process p and
    receive recv_bytes[p] bytes from it, for every p, by one all-to-all
    on comm_device() (on the card under NCCL, staged on the host under
    gloo); returns the received buffers there, in rank order.  The
    entries for this process are empty, and so may be any pair's: every
    process calls it all the same."""
    dev = comm_device()
    inp = torch.cat([s.to(dev) for s in send])
    out = torch.empty(sum(recv_bytes), dtype=torch.uint8, device=dev)
    dist.all_to_all_single(out, inp, output_split_sizes=list(recv_bytes),
                           input_split_sizes=[s.numel() for s in send])
    return list(torch.split(out, list(recv_bytes)))
