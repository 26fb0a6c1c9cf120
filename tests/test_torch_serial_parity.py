"""Where the two packages' integer state parts at crossbar widths, and why.

At the 40 nm crossbar's proportions (``tests/test_torch_rate_scale.py::
_models``: shifted-exponent rates, f32 pair plane, incremental selection, 15
V) the K-CG stops at ``1e-14 * n_int`` on r.z, far from converged, so any
change of the order of its dot products moves the boundary potentials, the
rates and then the events. The port's fused CG takes its dots in one blocked
order (the order that makes card and CPU agree), ``akmc_tpu``'s DIA solve
takes ``jnp.sum(a * b)`` (``f64_vdot``). ``parity(n_yz)`` reads, at one
width:

* the K-CG iteration counts and the boundary potentials of three solves of
  the cold fields: the port's, ``akmc_tpu``'s, and ``akmc_tpu``'s with
  ``jnp.dot`` in place of ``f64_vdot`` (its own second dot order);
* the largest relative difference of the rates (entries of at least 1e-6 of
  the largest rate) between the port and ``akmc_tpu``;
* the sites whose element differs after one serial superstep of each
  package on its own fields;
* the port's serial loop on ``akmc_tpu``'s own fields (``convert.fields``)
  against ``akmc_tpu``'s loop on them: events, draws and elements.

The tests hold the event half exactly and the fields within ``akmc_tpu``'s
own dot-order spread (``SPREAD_SLACK``); the readings at larger widths come
from running this file as a script:

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python -m tests.test_torch_serial_parity 12 16 24
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import akmc_tpu.solvers.dia as jdia
from akmc_tpu.ops import events as jev
from akmc_tpu.rng import BufferedStream as JStream
from akmc_tpu.rng import ReferenceRNG as JRNG
from akmc_tpu.state import make_device_state as j_state
from akmc_tpu_torch import convert
from akmc_tpu_torch.models.vcm import RAND_CHUNK
from akmc_tpu_torch.rng import BufferedStream as TStream
from akmc_tpu_torch.rng import ReferenceRNG as TRNG
from tests.test_torch_rate_scale import VD, _models

jax.config.update("jax_enable_x64", True)

# the port's potentials and rates may part from akmc_tpu's by this multiple
# of the distance between akmc_tpu's own two dot orders: that distance is one
# sample of how far a change of dot order moves the stopped solve, and the
# port's own order is a third (readings at n_yz = 4 to 24 in PERF.md §2: the
# port's distance is 0.5 to 1.4 times akmc_tpu's at the tested widths, up to
# 2.6 at n_yz = 16)
SPREAD_SLACK = 2.0
RATE_FLOOR = 1e-6


def _j_fields(jm, js, dot=None):
    """akmc_tpu's fields, traced afresh; ``dot`` replaces ``f64_vdot`` in its
    DIA solve."""
    saved = jdia.f64_vdot
    if dot is not None:
        jdia.f64_vdot = dot
    try:
        return jax.jit(lambda *a: jm._fields(*a))(
            jm.tables, jm.kop, js.element, js.charge, js.potential_boundary, js.T_bg, VD)
    finally:
        jdia.f64_vdot = saved


def _rate_rel(P, Q):
    P, Q = np.asarray(P), np.asarray(Q)
    big = P >= RATE_FLOOR * P.max()
    return float(np.max(np.abs(Q[big] - P[big]) / P[big]))


def parity(n_yz: int) -> dict:
    p, lat, jm, tm = _models(n_yz)
    js = j_state(lat, p.background_temp)
    ts = convert.state(js)
    fj = _j_fields(jm, js)
    fd = _j_fields(jm, js, dot=jnp.dot)
    ft = tm.fields(ts, VD)
    pj, pd = (np.asarray(f.potential_boundary) for f in (fj, fd))
    pt = ft.potential_boundary.numpy()
    out = {"n_yz": n_yz, "slots": lat.N,
           "cg_iterations": {"port": ft.cg_iterations, "akmc_tpu": int(fj.cg_iterations),
                             "akmc_tpu_jnp_dot": int(fd.cg_iterations)},
           "max_abs_dpb_V": {"port_vs_akmc_tpu": float(np.max(np.abs(pt - pj))),
                             "akmc_tpu_dot_orders": float(np.max(np.abs(pd - pj))),
                             "port_vs_akmc_tpu_jnp_dot": float(np.max(np.abs(pt - pd)))},
           "max_rate_rel": {"port_vs_akmc_tpu": _rate_rel(fj.P, ft.P.numpy()),
                            "akmc_tpu_dot_orders": _rate_rel(fj.P, fd.P)}}

    # the event half: both loops on akmc_tpu's own fields and the deck's stream
    t = jm.tables
    rj = jev.run_event_loop(
        js.element, fj.charge, fj.P, fj.etype, t.act_neigh,
        jnp.asarray(JStream(JRNG(p.rnd_seed_kmc)).peek(RAND_CHUNK)), p.freq,
        act_idx=t.act_idx, abs2act=t.abs2act, ln_S=fj.ln_S, zero_rows=t.act_zero_rows,
        incremental_select=True)
    tf = convert.fields(fj)
    rt = tm._events_to_the_end(ts.element, tf.charge, tf.P, tf.etype, tf.ln_S,
                               TStream(TRNG(p.rnd_seed_kmc)), RAND_CHUNK)
    out["loop_on_akmc_tpu_fields"] = {
        "events": [int(rj.n_events), rt.n_events],
        "draws_used": [int(rj.draws_used), rt.draws_used],
        "done": [bool(rj.done), rt.done],
        "elements_equal": bool(np.array_equal(np.asarray(rj.element), rt.element.numpy()))}

    # the whole superstep in each package, each on its own fields
    js1, sj = jm.superstep(js, VD, JStream(JRNG(p.rnd_seed_kmc)))
    ts1, st = tm.superstep(ts, VD, TStream(TRNG(p.rnd_seed_kmc)))
    out["superstep"] = {"events": [int(sj["n_events"]), int(st["n_events"])],
                        "sites_apart": int(np.sum(np.asarray(js1.element)
                                                  != ts1.element.numpy()))}
    return out


def _check(r):
    loop = r["loop_on_akmc_tpu_fields"]
    assert loop["events"][0] == loop["events"][1] >= 1 and loop["elements_equal"]
    assert loop["draws_used"][0] == loop["draws_used"][1] and all(loop["done"])
    d = r["max_abs_dpb_V"]
    assert d["port_vs_akmc_tpu"] <= SPREAD_SLACK * d["akmc_tpu_dot_orders"]
    assert d["port_vs_akmc_tpu_jnp_dot"] <= SPREAD_SLACK * d["akmc_tpu_dot_orders"]
    rr = r["max_rate_rel"]
    assert rr["port_vs_akmc_tpu"] <= SPREAD_SLACK * rr["akmc_tpu_dot_orders"]


# n_yz = 24 (about 90 s on one CPU core) is the smallest of the widths 4, 8,
# 12, 16, 20 and 24 where one serial superstep of each package on its own
# fields leaves the elements apart; n_yz = 12 is the tier-1 case, where the
# potentials already differ and the elements still agree
@pytest.mark.parametrize("n_yz, parted",
                         [(12, False), pytest.param(24, True, marks=pytest.mark.slow)],
                         ids=["n_yz=12", "n_yz=24"])
def test_events_exact_on_akmc_tpu_fields_where_the_fields_part(n_yz, parted):
    """The port's serial loop on akmc_tpu's fields fires akmc_tpu's events
    exactly, also at the width where the packages' own supersteps part; the
    fields part no further than SPREAD_SLACK times akmc_tpu's own dot
    orders do."""
    r = parity(n_yz)
    assert r["max_abs_dpb_V"]["port_vs_akmc_tpu"] > 0.0
    assert (r["superstep"]["sites_apart"] > 0) == parted
    assert r["superstep"]["events"][0] == r["superstep"]["events"][1]
    _check(r)


if __name__ == "__main__":
    for w in sys.argv[1:]:
        print(json.dumps(parity(int(w))), flush=True)
