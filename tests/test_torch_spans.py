"""The spans of the port's programs on the CPU (``runtime/profiling.py``,
``VCMModel.spans``): the names and parents each program kind opens, the
counts of the spans inside while bodies, children within their parents,
nothing stamped with spans off (and the same bits as with them on), a new
program captured when the switch moves, the per-loop path, the clock
alignment and the exporter's span track.

On the CPU the eager bodies stamp ``time.perf_counter_ns()`` into the same
tables that the card fills from ``%globaltimer``. No JAX: the port's own toy
device."""

import json

import pytest
import torch

from akmc_tpu_torch.models.crossbar import toy_device
from akmc_tpu_torch.models.vcm import VCMModel
from akmc_tpu_torch.ops.threefry import KeyDraws
from akmc_tpu_torch.rng import BufferedStream, ReferenceRNG
from akmc_tpu_torch.runtime import profiling
from akmc_tpu_torch.state import make_device_state

torch.set_num_threads(1)

FIELDS = ["charge", "k_solve", "pairwise", "rates"]
HOST = ["load", "launch", "read", "unpack"]
# each program kind: the device spans and their parents (besides "superstep")
KINDS = {
    "superstep": {**dict.fromkeys(FIELDS + ["event_loop"], "superstep")},
    "superstep_multi": {**dict.fromkeys(FIELDS + ["event_loop"], "superstep")},
    "batched": {**dict.fromkeys(FIELDS + ["key_split", "event_loop"], "superstep"),
                "batch.race": "event_loop", "batch.resolve": "event_loop"},
    "native": {**dict.fromkeys(FIELDS + ["key_split", "event_loop"], "superstep")},
    "full": {**dict.fromkeys(FIELDS + ["wkb_build", "power_solve", "event_loop", "heat"],
                             "superstep")},
    "fields": dict.fromkeys(FIELDS, "superstep"),
    "events_only": {"rates": "superstep", "event_loop": "superstep"},
    "cb_edge": {"cb_edge": "superstep"},
}


def _toy(full=False):
    p, lat = toy_device()
    if full:
        p = p.replace(
            solve_current=True, solve_heating_global=True, dissipation_constant=1e-13,
            t_ox=5e-9, A=(12 * 2.0e-10) ** 2, c_p=1.92, L_char=3.5e-10,
            num_atoms_contact=p.num_atoms_first_layer * p.num_layers_contact)
    return p, lat


def _kind(kind, spans=True, step_program=True, steps=2):
    """``steps`` dispatches of ``kind`` on the toy device: (model, the last
    state, each dispatch's stats, each dispatch's ``last_spans``)."""
    p, lat = _toy(full=kind == "full")
    m = VCMModel(p, lat, device="cpu", rate_normalize=True, step_program=step_program,
                 **(dict(ne_max=64) if kind == "full" else {}))
    m.spans = spans
    s = make_device_state(lat, p.background_temp, m.device)
    if kind in ("full", "cb_edge"):
        s = m.update_cb_edge(s, 2.0)
    stream, draws = BufferedStream(ReferenceRNG(1)), KeyDraws.seeded(5, "cpu")
    stats, tables = [], []
    for _ in range(steps):
        if kind == "superstep":
            s, st = m.superstep(s, 2.0, stream)
        elif kind == "superstep_multi":
            s, st = m.superstep_multi(s, 2.0, stream, k=3)
        elif kind == "batched":
            s, st = m.superstep_native_batched(s, 2.0, draws, batch=8)
        elif kind == "native":
            s, st = m.superstep_native(s, 2.0, draws)
        elif kind == "full":
            s, st, _ = m.superstep_full(s, 2.0, stream)
        elif kind == "fields":
            s, st = m.fields_only(s, 2.0)
        elif kind == "events_only":
            s, st = m.superstep_events_only(s, stream)
        else:
            s, st = m.update_cb_edge(s, 3.0), {}
        stats.append(st)
        tables.append(m.last_spans)
    return m, s, stats, tables


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_span_names_and_parents_of_each_program_kind(kind):
    """Each program kind opens ``superstep`` around its body and the spans of
    the modules it runs under it (the batch's two inside ``event_loop``),
    with the anchor and the four host phases of the dispatch beside them."""
    _, _, _, tables = _kind(kind)
    spans = tables[-1]
    device = {k: v["parent"] for k, v in spans.items() if v["clock"] == "device"}
    assert device == {"superstep": None, **KINDS[kind], "anchor": None}
    assert sorted(k for k, v in spans.items() if v["clock"] == "host") == sorted(HOST)
    assert all(v["n"] >= 1 and v["ms"] >= 0.0 for k, v in spans.items() if k != "anchor")
    assert spans["anchor"]["start_ns"] <= spans["superstep"]["start_ns"]


@pytest.mark.parametrize("kind", ["batched", "superstep_multi", "superstep", "full"])
def test_span_counts_are_passes_and_solves(kind):
    """``batch.race`` and ``batch.resolve`` close once a batch (one batch a
    pass of the while node), ``k_solve`` once a superstep: k a dispatch of
    ``superstep_multi``; ``superstep`` once a dispatch."""
    _, _, stats, tables = _kind(kind)
    for st, spans in zip(stats, tables):
        k = len(st) if isinstance(st, list) else 1
        assert spans["superstep"]["n"] == 1
        assert spans["k_solve"]["n"] == spans["event_loop"]["n"] == k
        if kind == "batched":
            assert spans["batch.race"]["n"] == spans["batch.resolve"]["n"] == st["n_batches"]


@pytest.mark.parametrize("kind", ["batched", "full"])
def test_children_lie_within_their_parents(kind):
    """Children's time adds up to no more than the parent's (self time at
    least 0), and each child opens and closes within its parent."""
    _, _, _, tables = _kind(kind)
    for spans in tables:
        dev = {k: v for k, v in spans.items() if v["clock"] == "device" and k != "anchor"}
        for name, s in dev.items():
            kids = [c for c in dev.values() if c["parent"] == name]
            assert sum(c["ms"] for c in kids) <= s["ms"] + 1e-9, name
            assert s["self_ms"] >= -1e-9
            for c in kids:
                assert s["start_ns"] <= c["start_ns"] and c["end_ns"] <= s["end_ns"], name


@pytest.mark.parametrize("kind", ["batched", "superstep", "full", "fields"])
def test_spans_off_stamps_nothing_and_changes_no_bit(kind, monkeypatch):
    """With spans off no stamp is made (the stamp function raises if called)
    and no table is read; states and stats are those of a run with spans
    on, bit for bit."""
    _, s_on, st_on, _ = _kind(kind, spans=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a span stamped with spans off")

    monkeypatch.setattr(profiling, "stamp", refuse)
    m, s_off, st_off, tables = _kind(kind, spans=False)
    assert st_off == st_on and all(t == {} for t in tables)
    assert all(p.spans is None for p in m.step_graphs.programs.values())
    for name in ("element", "charge", "potential_boundary", "potential_charge", "kmc_time"):
        assert torch.equal(getattr(s_on, name), getattr(s_off, name)), name


def test_switching_spans_builds_a_new_program():
    """``spans`` is part of every program's key: a switch builds (on a card
    captures) a program of its own, and switching back takes the old one."""
    m, s, _, _ = _kind("batched", spans=False, steps=1)
    off = set(map(id, m.step_graphs.programs.values()))
    draws = KeyDraws.seeded(5, "cpu")
    m.spans = True
    s, _ = m.superstep_native_batched(s, 2.0, draws, batch=8)
    on = set(map(id, m.step_graphs.programs.values())) - off
    assert len(on) == 1 and next(p for p in m.step_graphs.programs.values()
                                 if id(p) in on).spans is not None
    m.spans = False
    m.superstep_native_batched(s, 2.0, draws, batch=8)
    assert len(m.step_graphs.programs) == len(off) + 1


@pytest.mark.parametrize("kind", ["superstep", "batched", "full"])
def test_per_loop_path_spans(kind):
    """Without programs the dispatch is one ``superstep`` span in the model's
    own table (read once at its end), with the modules under it; loops
    replayed from the host carry no span of their own."""
    _, s_loop, st_loop, tables = _kind(kind, step_program=False)
    spans = tables[-1]
    want = {"superstep": None, "anchor": None, **dict.fromkeys(FIELDS, "superstep"),
            "event_loop": "superstep"}
    if kind == "full":
        want.update(dict.fromkeys(["wkb_build", "power_solve", "heat"], "superstep"))
    assert {k: v["parent"] for k, v in spans.items()} == want
    _, s_prog, st_prog, _ = _kind(kind)
    assert st_loop == st_prog
    assert torch.equal(s_loop.element, s_prog.element)


def test_int32_halves_carry_a_nanosecond_clock_exactly():
    """A table read through f64 halves gives the int64 words back exactly,
    at a clock of 1.8e18 ns (above f64's 2**53)."""
    table = profiling.SpanTable(torch.device("cpu"))
    table.open("a")
    table.close("a")
    big = 1_800_000_000_123_456_789
    table.stamps[0, 2], table.stamps[0, 3] = big, big + 4321
    table.anchor[0] = big - 17
    got = table.read([v for t in table.tensors() for v in t.to(torch.float64).tolist()])
    assert got["a"]["start_ns"] == big and got["a"]["end_ns"] == big + 4321
    assert got["anchor"]["start_ns"] == big - 17 and got["a"]["n"] == 1


def _dispatch(anchor_ns, spans):
    out = {"anchor": {"start_ns": anchor_ns, "end_ns": anchor_ns, "n": 1, "parent": None,
                      "clock": "device", "ms": 0.0, "self_ms": 0.0}}
    for name, parent, a, b in spans:
        out[name] = {"start_ns": anchor_ns + a, "end_ns": anchor_ns + b, "n": 1,
                     "parent": parent, "clock": "device", "ms": (b - a) * 1e-6,
                     "self_ms": 0.0}
    out["load"] = {"start_ns": 5, "end_ns": 9, "n": 1, "parent": None, "clock": "host",
                   "ms": 0.0, "self_ms": 0.0}
    return out


def test_align_puts_device_spans_on_the_profile_clock():
    """Each dispatch's offset is its anchor kernel's start less the anchor's
    clock value; an extra anchor before the dispatches (a redone one) is
    passed over; host spans are left out."""
    d = [_dispatch(10_000_000, [("superstep", None, 2_000, 50_000)]),
         _dispatch(10_090_000, [("superstep", None, 3_000, 60_000)])]
    starts = [5.0, 100.0, 190.5]          # µs: a stray anchor, then the two
    got = profiling.align_starts(starts, d)
    assert got.offsets_us == pytest.approx([100.0 - 10_000.0, 190.5 - 10_090.0])
    assert got.offset_spread_us == pytest.approx(0.5)
    assert [(n, round(a, 3), round(b, 3)) for n, _, a, b, _, _ in got.spans] == [
        ("superstep", 102.0, 150.0), ("superstep", 193.5, 250.5)]
    assert profiling.align_starts([1.0], d).spans == []


def test_trace_writes_the_aligned_spans_on_their_own_track(tmp_path):
    """The exporter's span track: one event per device span, on the anchors
    the file itself holds, at the depth of its parent chain."""
    d = [_dispatch(1_000_000, [("superstep", None, 1_000, 9_000),
                               ("event_loop", "superstep", 4_000, 8_000)])]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "span_anchor", "cat": "kernel", "ts": 500.0, "dur": 1.0}]}))
    profiling._add_span_track(str(path), d)
    events = json.loads(path.read_text())["traceEvents"]
    track = {e["name"]: e for e in events if e.get("pid") == "akmc spans"}
    assert track["superstep"]["ts"] == pytest.approx(501.0)
    assert track["superstep"]["dur"] == pytest.approx(8.0)
    assert track["event_loop"]["tid"] == 1 and track["superstep"]["tid"] == 0


def test_trace_collects_the_dispatches_of_its_block(tmp_path):
    """``trace`` gathers the spans of the dispatches made inside it (none
    aligned on the CPU: no anchor kernel) and writes a valid file."""
    m, s, _, _ = _kind("fields", steps=1)
    with profiling.collecting() as got, profiling.trace(str(tmp_path)):
        m.fields_only(s, 2.0)
    assert len(got) == 1 and got[0]["superstep"]["n"] == 1
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())
