"""One process of a two-process run on the CPU, for
tests/test_torch_cards.py: the collectives of
neutral_tpu_torch/parallel/distributed.py against copies of the functions
they replaced (the host-staged gather of counter rows after one read, the
numpy all-gather, the host-packed exchange), over gloo.

Usage: python tests/_torch_cards_worker.py <process_id> <port>

Every case prints `OK <name>` when the new function returns bitwise what
the old one returns; any difference raises, and the process exits
non-zero.  It imports nothing of JAX.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from neutral_tpu_torch.parallel import distributed  # noqa: E402
from neutral_tpu_torch.parallel.common import (pack_lanes,  # noqa: E402
                                               packed_bytes, unpack_lanes)
from neutral_tpu_torch.particles import STATE_FIELDS  # noqa: E402

rank, port = int(sys.argv[1]), sys.argv[2]
distributed.initialise_distributed(f"127.0.0.1:{port}", 2, rank,
                                   timeout=datetime.timedelta(seconds=60))
assert distributed.backend() == "gloo"
assert distributed.comm_device() == torch.device("cpu")


# -- the functions as they were before the collectives moved to the cards --
def old_read_counters(rows):
    return torch.stack([r.to(rows[0].device) for r in rows]).cpu().numpy()


def old_all_gather_rows(block):
    t = torch.from_numpy(np.ascontiguousarray(block, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(2)]
    dist.all_gather(out, t)
    return torch.cat(out).numpy()


def old_all_gather_arrays(arrays):
    sizes = torch.tensor([a.nbytes for a in arrays], dtype=torch.int64)
    all_sizes = [torch.empty_like(sizes) for _ in range(2)]
    dist.all_gather(all_sizes, sizes)
    width = max(int(s.sum()) for s in all_sizes)
    buf = torch.zeros(width, dtype=torch.uint8)
    off = 0
    for a in arrays:
        buf[off:off + a.nbytes] = torch.from_numpy(
            np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        off += a.nbytes
    out = [torch.empty_like(buf) for _ in range(2)]
    dist.all_gather(out, buf)
    result = []
    for s, b in zip(all_sizes, out):
        off, b = 0, b.numpy()
        for a, nbytes in zip(arrays, s.tolist()):
            result.append(b[off:off + nbytes].view(a.dtype).copy())
            off += nbytes
    return result


def old_pack_lanes(blocks):
    device = blocks[0][0].device
    parts = []
    for i in range(len(STATE_FIELDS)):
        b = torch.cat([blk[i].to(device) for blk in blocks]).view(torch.uint8)
        parts += [b, b.new_zeros(-b.numel() % 8)]
    return torch.cat(parts).cpu()


def old_exchange(send, recv_bytes):
    inp = torch.cat(send)
    out = torch.empty(sum(recv_bytes), dtype=torch.uint8)
    dist.all_to_all_single(out, inp, output_split_sizes=list(recv_bytes),
                           input_split_sizes=[s.numel() for s in send])
    return list(torch.split(out, list(recv_bytes)))


# -- seeded data ---------------------------------------------------------------
# A float32 run's fields (odd counts of 4-byte and 1-byte values leave the
# packed fields' padding to check), its deposit in float64.
DTYPES = {"x": torch.float32, "y": torch.float32, "omega_x": torch.float32,
          "omega_y": torch.float32, "energy": torch.float32,
          "weight": torch.float32, "dt_to_census": torch.float32,
          "mfp_to_collision": torch.float32, "deposit": torch.float64,
          "cellx": torch.int32, "celly": torch.int32, "dead": torch.bool,
          "pid": torch.int64, "counter": torch.int64}


def lanes(seed, k):
    """k seeded lanes: one tensor a STATE_FIELDS field."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for f in STATE_FIELDS:
        dtype = DTYPES[f]
        if dtype == torch.bool:
            out.append(torch.randint(0, 2, (k,), generator=g).bool())
        elif dtype.is_floating_point:
            out.append(torch.randn(k, generator=g, dtype=dtype))
        else:
            out.append(torch.randint(-2**31, 2**31 - 1, (k,), generator=g,
                                     dtype=dtype))
    return out


def check(name, got, want):
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    print(f"OK {name}", flush=True)


rng = np.random.default_rng(rank)
# The step's begin gather ([live], [lanes]) and a chunk's (counters and
# departures, [launched, sweeps]) of two shards a process.
for name, width, extra in (("begin", 1, 1), ("chunk", 3 + 4 + 1, 2),
                           ("flight chunk", 6 + 4 + 1, 2)):
    rows = [torch.from_numpy(rng.integers(0, 2**40, width)) for _ in range(2)]
    host = rng.integers(0, 2**20, (2, extra))
    check(f"gather_counters {name}",
          [distributed.gather_counters(rows, host)],
          [old_all_gather_rows(np.concatenate([old_read_counters(rows),
                                               host], 1))])

# Tallies and states: every dtype of a state, lengths that differ by
# process (process 1 has one empty array).
tensors = [lane for k in ((5, 0) if rank else (3, 7))
           for lane in lanes(100 + rank + k, k)]
check("all_gather_arrays", distributed.all_gather_arrays(tensors),
      old_all_gather_arrays([t.numpy() for t in tensors]))

# The exchange: process 0 sends process 1 two blocks (from its shards 0 and
# 1), process 1 sends nothing; then both send.
like = type("Like", (), {f: torch.empty(0, dtype=DTYPES[f])
                         for f in STATE_FIELDS})()
for name, counts in (("one way", ((4, 9), ())), ("both ways", ((4, 9), (6,)))):
    mine = [lanes(10 * rank + j, k) for j, k in enumerate(counts[rank])]
    theirs = counts[1 - rank]
    empty = torch.empty(0, dtype=torch.uint8)
    send_new = [empty, empty]
    send_old = [empty, empty]
    if mine:
        send_new[1 - rank] = pack_lanes(mine, torch.device("cpu"))
        send_old[1 - rank] = old_pack_lanes(mine)
    recv = [0, 0]
    recv[1 - rank] = packed_bytes(like, sum(theirs))
    got = distributed.exchange(send_new, recv)
    want = old_exchange(send_old, recv)
    check(f"exchange {name}", [g.numpy() for g in got],
          [w.numpy() for w in want])
    if theirs:
        blocks = unpack_lanes(got[1 - rank], list(theirs), like)
        sent = [lanes(10 * (1 - rank) + j, k) for j, k in enumerate(theirs)]
        check(f"exchange {name} lanes", [t.numpy() for b in blocks for t in b],
              [t.numpy() for b in sent for t in b])
print(f"DONE {rank}", flush=True)
