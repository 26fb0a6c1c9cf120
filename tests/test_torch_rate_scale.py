"""The 40 nm crossbar's rate scale in both packages, and what it does to f32
clocks.

With shifted-exponent rates (``rate_normalize``) the rate table holds
exp(z_min - z) and ln_S = ln(freq) - z_min carries the scale. The batched
loop ends a superstep on the first accepted gap tau with ln(tau) - ln_S >=
ln(1 / freq): in the clocks' scaled units a gap of exp(ln_S) / freq. An f32
clock holds no gap beyond f32's largest value (3.40e38), so on fields with
ln_S > ln(freq) + ln(3.40e38) no f32 clock can end the superstep: the loop
fires the events it can and then makes batches until ``max_batches``, in
both packages, step for step.

``rate_scale(n_yz)`` builds the crossbar of ``tools/bench_crossbar.py`` and
of ``chip_smoke.py``'s flagship phase at width ``n_yz``
(``build_grid_crossbar(n_yz, 10/22/8 slices, defect 0.1, vacancies 0.05,
seed 0)``; the flagship is n_yz = 215) with shifted-exponent rates, the f32
pair plane and incremental selection, at 15 V, in both packages: ln_S of the
cold fields, one serial superstep on the deck's mt19937 stream, ln_S of the
fields after it. The tests run it at small widths; larger ones run as a
script (about 7 minutes and 7 GB of host memory for 64 and 104):

    JAX_PLATFORMS=cpu python -m tests.test_torch_rate_scale 64 104
"""

import json
import math
import sys

import jax
import numpy as np
import pytest

from akmc_tpu.models.crossbar import build_grid_crossbar
from akmc_tpu.models.vcm import VCMModel as JModel
from akmc_tpu.ops import events as jev
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import VCMModel as TModel
from akmc_tpu_torch.ops import events as tev
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from tests.test_torch_events_batched import T, _same_trajectory, batched_schedule

jax.config.update("jax_enable_x64", True)

VD = 15.0
LN_F32_MAX = math.log(float(np.finfo(np.float32).max))     # 88.72


def _models(n_yz):
    p, lat = build_grid_crossbar(n_yz=n_yz, contact_slices=10, oxide_slices=22, ti_slices=8,
                                 defect_fraction=0.1, vacancy_concentration=0.05, seed=0)
    kw = dict(rate_normalize=True, pair_f32=True, event_select_incremental=True)
    jm = JModel(p, lat, **kw)
    tm = TModel(convert.params(p), convert.lattice(lat), device="cpu", **kw)
    return p, lat, jm, tm


def _j_fields(jm, js):
    return jax.jit(jm._fields)(jm.tables, jm.kop, js.element, js.charge,
                               js.potential_boundary, js.T_bg, VD)


def rate_scale(n_yz: int) -> dict:
    """Both packages on the crossbar of width ``n_yz`` at 15 V: ln_S of the
    cold fields, one serial superstep (events, KMC time, whether the two
    element arrays are equal), ln_S after it, and the ln_S beyond which f32
    clocks cannot end a superstep."""
    p, lat, jm, tm = _models(n_yz)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    out = {"n_yz": n_yz, "slots": lat.N, "ln_S_f32_limit": math.log(p.freq) + LN_F32_MAX,
           "cold_ln_S": [float(_j_fields(jm, js).ln_S), float(tm.fields(ts, VD).ln_S)]}
    js, sj = jm.superstep(js, VD, JStream(JRNG(p.rnd_seed_kmc)))
    ts, st = tm.superstep(ts, VD, TStream(TRNG(p.rnd_seed_kmc)))
    out.update(events=[int(sj["n_events"]), int(st["n_events"])],
               kmc_time=[float(js.kmc_time), float(ts.kmc_time)],
               elements_equal=bool(np.array_equal(np.asarray(js.element), ts.element.numpy())),
               ln_S=[float(_j_fields(jm, js).ln_S), float(tm.fields(ts, VD).ln_S)])
    return out


@pytest.mark.parametrize("n_yz", [4, 6, 8])
def test_rate_scale_agrees_with_akmc_tpu(n_yz):
    """The same cold rate scale, then the same serial superstep: events and
    elements equal, KMC time and the new ln_S to the K solve's stop
    tolerance (the two packages' potentials agree to it, not to the bit)."""
    r = rate_scale(n_yz)
    assert r["cold_ln_S"][1] == pytest.approx(r["cold_ln_S"][0], rel=1e-7)
    assert r["events"][0] == r["events"][1] >= 1 and r["elements_equal"]
    assert r["kmc_time"][1] == pytest.approx(r["kmc_time"][0], rel=1e-6)
    assert r["ln_S"][1] == pytest.approx(r["ln_S"][0], rel=1e-7)
    assert max(r["ln_S"]) < r["ln_S_f32_limit"]


@pytest.fixture(scope="module")
def fields6():
    """akmc_tpu's fields at n_yz = 6 after one serial superstep, and the
    port's copies."""
    p, lat, jm, _ = _models(6)
    js = j_state(lat, p.background_temp)
    js, _ = jm.superstep(js, VD, JStream(JRNG(p.rnd_seed_kmc)))
    fr = _j_fields(jm, js)
    return p, jm.tables, js, fr, convert.tables(jm.tables), convert.fields(fr)


@pytest.mark.parametrize("beyond", [None, 0.5, 5.0, 30.0],
                         ids=["own-scale", "limit+0.5", "limit+5", "limit+30"])
def test_f32_clocks_cannot_end_beyond_f32_range(fields6, beyond):
    """The f32-clock loop on the same table: at the fields' own ln_S it ends
    (both packages, step for step); with ln_S set ``beyond`` the f32 limit
    it fires events and then uses up its batches, ``done`` False with a
    waiting time of 0, in both packages with the same trajectory."""
    p, t, js, fr, tt, tf = fields6
    ln_S = fr.ln_S if beyond is None else jax.numpy.asarray(
        math.log(p.freq) + LN_F32_MAX + beyond, jax.numpy.float64)
    key = jax.random.PRNGKey(3)
    kw = dict(batch=4, max_batches=40, clock_f32=True, mass_eps=0.1)
    rj = jev.run_event_loop_batched(js.element, fr.charge, fr.P, fr.etype, t.act_neigh, key,
                                    p.freq, act_idx=t.act_idx, abs2act=t.abs2act, ln_S=ln_S, **kw)
    rt = tev.run_event_loop_batched(
        T(js.element), tf.charge, tf.P.clone(), tf.etype, tt.act_neigh,
        tev.ReplayDraws(batched_schedule(key, fr.P.shape[0], 4, True)), p.freq,
        act_idx=tt.act_idx, abs2act=tt.abs2act, ln_S=T(ln_S), **kw)
    _same_trajectory(rt, rj, 1e-6)
    assert rt.n_batches == int(rj.n_batches) and rt.n_events >= 1
    if beyond is None:
        assert rt.done and rt.n_batches < 40 and rt.event_time_h > 0.0
    else:
        assert (rt.done, rt.n_batches, rt.event_time_h) == (False, 40, 0.0)


if __name__ == "__main__":
    for n in sys.argv[1:] or ["64"]:
        print(json.dumps(rate_scale(int(n))), flush=True)
