"""The whole slice: akmc_tpu_torch's superstep and driver against akmc_tpu's
on the CPU.

* Three supersteps of ``VCMModel.superstep`` on the grid-native toy crossbar
  of ``tests/test_dia.py``, in both rate modes, from the same state and the
  same mt19937 stream: equal events, CG iterations, draws, elements and
  charges; waiting times to rtol 1e-7.
* Both drivers over the whole 15-point sweep of ``decks/iv_sweep_5nm.txt`` at
  ``--synthesize-crossbar 6``: the same ``output1_0.txt`` apart from the
  ``calculation time`` lines, ``KMC time is:`` to rtol 1e-7, and the same
  element column in every snapshot.

KMC times are exponentials of potentials that the K-system CG returns to its
stopping tolerance, so reassociated dot products move them far more than an
ulp; 1e-7 is the bound at these sizes (measured gaps are below 1e-9).
"""

import json
import re

import numpy as np
import pytest
import torch

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.runtime import driver as jdriver
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.lattice import ELEM
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from akmc_tpu_torch.runtime import driver as tdriver
from akmc_tpu_torch.runtime import golden


# PyTorch's CPU worker threads, when first started in a process where JAX is
# also computing, were seen to return one thread's whole chunk of an
# elementwise op up to 1e-9 off (about one process in 40; never the calling
# thread's chunk). The comparisons below run PyTorch on the calling thread.
torch.set_num_threads(1)

KMC_RTOL = 1e-7
DECK = "decks/iv_sweep_5nm.txt"


@pytest.fixture(scope="module")
def grid():
    return build_grid_crossbar(
        n_yz=6, contact_slices=2, oxide_slices=6, ti_slices=2,
        defect_fraction=0.3, vacancy_concentration=0.1, seed=3,
    )


@pytest.mark.parametrize("rate_normalize", [False, True], ids=["absolute", "shifted"])
def test_three_supersteps_match(grid, rate_normalize):
    p, lat = grid
    jm = JModel(p, lat, rate_normalize=rate_normalize)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu",
                rate_normalize=rate_normalize)
    assert tm.dia_meta == jm.dia_meta and (tm.qmax, tm.vmax) == (jm.qmax, jm.vmax)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    jstream, tstream = JStream(JRNG(1)), TStream(TRNG(1))
    n_events = 0
    for Vd in (2.0, 2.0, 6.0):
        js, jst = jm.superstep(js, Vd, jstream)
        ts, tst = tm.superstep(ts, Vd, tstream)
        assert (tst["n_events"], tst["cg_iterations"]) == (jst["n_events"], jst["cg_iterations"])
        assert tst["event_time"] == pytest.approx(jst["event_time"], rel=KMC_RTOL)
        assert tstream.peek(1)[0] == jstream.peek(1)[0]   # same draws consumed
        np.testing.assert_array_equal(ts.element.numpy(), np.asarray(js.element))
        np.testing.assert_array_equal(ts.charge.numpy(), np.asarray(js.charge))
        np.testing.assert_allclose(ts.potential_boundary.numpy(),
                                   np.asarray(js.potential_boundary), rtol=1e-8, atol=1e-9)
        n_events += tst["n_events"]
    assert n_events >= 3
    assert float(ts.kmc_time) == pytest.approx(float(js.kmc_time), rel=KMC_RTOL)
    null0 = lat.element0 == int(ELEM.NULL_ELEMENT)
    assert (ts.element.numpy()[null0] == int(ELEM.NULL_ELEMENT)).all()


def _elements(path):
    return [ln.split()[0] for ln in path.read_text().splitlines()[2:] if ln.strip()]


def test_driver_sweep_matches(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdriver.run(DECK, workdir=str(jdir), synthesize_crossbar=6, dia_pallas=False,
                cache_dir=None, log=False)
    tdriver.run(DECK, workdir=str(tdir), synthesize_crossbar=6, dia_pallas=True,
                device="cpu", log=False)

    jl = (jdir / "output1_0.txt").read_text().splitlines()
    tl = (tdir / "output1_0.txt").read_text().splitlines()
    assert len(tl) == len(jl)
    n_kmc = 0
    for a, b in zip(jl, tl):
        if "calculation time" in a:
            assert re.sub(r"[-+.0-9e]+$", "", a) == re.sub(r"[-+.0-9e]+$", "", b)
        elif a.startswith("KMC time is: "):
            n_kmc += 1
            assert float(b.split(": ")[1]) == pytest.approx(float(a.split(": ")[1]), rel=KMC_RTOL)
        else:
            assert b == a
    assert n_kmc >= 15

    jm = [json.loads(ln) for ln in (jdir / "metrics.jsonl").read_text().splitlines()]
    tm = [json.loads(ln) for ln in (tdir / "metrics.jsonl").read_text().splitlines()]
    assert [(m["bias"], m["step"], m["n_events"]) for m in tm] == [
        (m["bias"], m["step"], m["n_events"]) for m in jm]

    snaps = sorted(p.relative_to(jdir) for p in jdir.glob("Results_*/snapshot_*.xyz"))
    assert len(snaps) == 30
    assert snaps == sorted(p.relative_to(tdir) for p in tdir.glob("Results_*/snapshot_*.xyz"))
    for rel in snaps:
        assert _elements(tdir / rel) == _elements(jdir / rel), rel

    # the golden record and its comparison, as chip_smoke.py uses them
    assert golden.compare(golden.summarize(str(jdir)), golden.summarize(str(tdir)), KMC_RTOL) == []
    bad = golden.summarize(str(tdir))
    bad["supersteps"][3]["n_events"] += 1
    bad["final_elements"] = bad["final_elements"][:-1] + "9"
    assert len(golden.compare(golden.summarize(str(jdir)), bad, KMC_RTOL)) == 2


def test_driver_refuses_what_is_not_ported(tmp_path):
    # every option of akmc_tpu's driver is ported; what it refuses the port
    # refuses too: --devices with --concern-split, and an unknown option
    with pytest.raises(ValueError, match="exclusive"):
        tdriver.run(DECK, workdir=str(tmp_path), synthesize_crossbar=6, device="cpu",
                    concern_split=(1, 3), devices=2)
    with pytest.raises(TypeError):
        tdriver.run(DECK, workdir=str(tmp_path), device="cpu", no_such_option=1)
    assert torch.get_default_dtype() == torch.float32   # the port never changes it
