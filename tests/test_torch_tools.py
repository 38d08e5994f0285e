"""The port's tools CLI (neutral_tpu_torch.tools) and its native engine
(neutral_tpu_torch.native) against neutral_tpu's.

The native engine is built from the port's own copy of
`neutral_native.cpp` (neutral_tpu's, line for line but one comment),
inside a test body (never at collection).  `compare
--device cpu` must print AGREE on a scatter-like deck, on a stretched
mesh and (flight transport) on a stream-like deck: equal per-step counts and tallies within 1e-10 of the C++ engine,
JAX's contract (neutral_tpu/tools.py:88-97).  `--backend native` prints
the reference's per-step contract and refuses what it cannot do.
"""

import re

import numpy as np
import pytest
import torch

from neutral_tpu_torch import driver, native, rng, tools

STRETCHED = """\
nparticles 200
initial_energy 1.0e4
dt 1.0e-7
nx 40
ny 40
iterations 2
mesh_stretch_x 1.08
mesh_stretch_y 0.93
source xpos=0.1 ypos=0.1 width=0.3 height=0.3
problem_0 density=1.0e2 energy=0.0 xpos=0.0 ypos=0.0 width=1.0 height=1.0
problem_1 density=1.0e4 energy=0.0 xpos=0.4 ypos=0.4 width=0.2 height=0.2
"""


def test_native_source_is_jax_copy():
    """The port's neutral_native.cpp is neutral_tpu's line for line, but
    for the one comment that cites the reference's omp3 backend, which
    names it as "the reference's" instead of by a mount path."""
    with open("neutral_tpu/native/neutral_native.cpp") as f:
        jax = f.read().splitlines()
    port = native.SOURCE.read_text().splitlines()
    differ = [i for i, (a, b) in enumerate(zip(port, jax)) if a != b]
    assert len(port) == len(jax) and len(differ) == 1
    cite = "omp3/neutral.c:43-420: the until-census history loop with"
    assert port[differ[0]] == f"// (the reference's {cite}"
    assert jax[differ[0]].endswith(cite)
    assert native.library_path().parent.name == "build"


def test_native_draws_match_port_rng():
    """The C++ engine's threefry draws equal the port's float64 draws
    bitwise, and its PCG64si seeding the port's (both schemes' streams)."""
    for pid, mk, c in [(0, 0, 0), (5, 3, 17), (999, 1, 2), (2**31, 7, 9)]:
        r0, r1 = rng.uniform2(torch.tensor([pid]), mk, c, torch.float64)
        assert native.draw2(pid, mk, c) == (float(r0), float(r1))
    for seed in (0, 1, 42, 10**15 + 10**4 + 6, 2**64 - 1):
        hi, lo = rng.pcg64si_first(torch.tensor([seed >> 32]),
                                   torch.tensor([seed & 0xFFFFFFFF]))
        assert native.pcg64si_first(seed) == (int(hi) << 32) | int(lo)


def test_gen_cs_is_byte_equal_to_jax(tmp_path, capsys):
    from neutral_tpu import tools as jtools

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    assert tools.main(["gen-cs", str(tmp_path / "port")]) == 0
    assert jtools.main(["gen-cs", str(tmp_path / "jax")]) == 0
    for name in ("elastic_scatter.cs", "capture.cs"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())


@pytest.mark.parametrize("deck,argv,transport", [
    ("problems/scatter.params", ["--nparticles", "500", "--mesh-scale", "62"],
     "sweep"),
    ("stretched", [], "sweep"),
    ("problems/stream.params", ["--nparticles", "300", "--mesh-scale", "125"],
     "flight"),
])
def test_compare_agrees_on_cpu(deck, argv, transport, tmp_path, capsys):
    if deck == "stretched":
        deck = str(tmp_path / "stretched.params")
        with open(deck, "w") as f:
            f.write(STRETCHED)
    assert tools.main(["compare", deck, *argv, "--device", "cpu",
                       "--transport", transport]) == 0
    out = capsys.readouterr().out
    assert f"AGREE (port {transport} transport on cpu)" in out
    steps = re.findall(r"step \d+: native ev=(\(.*?\)) port ev=(\(.*?\)) OK",
                       out)
    assert steps and all(a == b for a, b in steps)
    rel = float(re.search(r"rel=(\S+)", out)[1])
    assert rel < tools.AGREE_RTOL


def test_backend_native_prints_the_contract(capsys):
    argv = ["problems/scatter.params", "--nparticles", "500",
            "--mesh-scale", "62"]
    assert driver.main([*argv, "--backend", "native"]) == 0
    out = capsys.readouterr().out
    for line in ("Native engine with", "Iteration  1", "Iteration  2",
                 "Step time", "Wallclock", "Facets", "Collisions",
                 "Facet Events / s", "Collision Events / s",
                 "Final global_energy_tally", "Final Wallclock",
                 "Elapsed Simulation Time"):
        assert line in out, line
    total = float(re.search(r"Final global_energy_tally (\S+)", out)[1])
    assert tools.main(["gen-golden", argv[0], "--nparticles", "500"]) == 0
    golden = capsys.readouterr().out
    assert golden.startswith("problems/scatter.params result=")
    # the deck at full mesh size against the cut-down one: same physics
    # per particle, to the statistics of 500 histories
    assert float(golden.split("=")[1]) == pytest.approx(total, rel=0.05)
    assert np.isfinite(total) and total > 0.0


@pytest.mark.parametrize("flag", [["--checkpoint", "x.npz"],
                                  ["--restore", "x.npz"],
                                  ["--trace-dir", "t"], ["--shards", "4"],
                                  ["--decomposition", "spatial"]])
def test_backend_native_rejects(flag, capsys):
    with pytest.raises(SystemExit) as e:
        driver.main(["problems/scatter.params", "--backend", "native", *flag])
    assert e.value.code == 2
    assert f"does not support: {flag[0]}" in capsys.readouterr().err
