"""Census master keys made from (seed, replica, step) run cleanly, far
beyond the deck's step count: nothing in the program assumes tt <=
niters."""

import pytest
import torch

from neutral_tpu_torch import driver
from neutral_tpu_torch.parallel import Spatial2DSimulation
from neutral_tpu_torch import begin_kernel, flight_kernel, sweep_kernel
from portbench import check, harness


def test_keys_are_63_bit_odd_and_distinct():
    keys = {check.master_key(2**31 + 17, r, s)
            for r in range(-1, 50) for s in range(1, 11)}
    assert len(keys) == 51 * 10
    assert all(0 < k < 2**63 and k % 2 == 1 for k in keys)
    assert check.master_key(7, 0, 1) == check.master_key(7, 0, 1)


@pytest.mark.parametrize("transport", ["sweep", "flight"])
def test_large_keys_through_one_device_and_blocks(transport):
    config = {**harness.find_cell("csp.f32")["config"], "nx": 40, "ny": 40,
              "nparticles": 200, "iterations": 2}
    cfg = harness.sim_config(config, {"dtype": "float32",
                                      "tally_dtype": "float32"})
    keys = [check.master_key(2**33 + 5, 10**6, s) for s in (1, 2)]
    one = driver.Simulation(cfg, device="cpu", transport=transport,
                            quiet=True)
    blocks = Spatial2DSimulation(cfg, devices=["cpu"] * 4,
                                 transport=transport, quiet=True)
    for k in keys:
        a, b = one.step(k), blocks.step(k)
        assert a.nprocessed == b.nprocessed == 200
        assert (a.nfacets, a.ncollisions) == (b.nfacets, b.ncollisions)
    assert one.host_tally().sum() == pytest.approx(
        blocks.host_tally().sum(), rel=1e-5)


@pytest.mark.parametrize("params", [sweep_kernel._SweepParams,
                                    sweep_kernel._SweepParams64,
                                    flight_kernel._FlightParams,
                                    begin_kernel._BeginParams64])
def test_the_kernels_take_a_64_bit_key(params):
    p = params()
    key = check.master_key(2**31 + 1, 99, 2)
    p.master_key = key
    assert p.master_key == key <= torch.iinfo(torch.int64).max
