"""The serial superstep as one program: on a card one CUDA graph per dispatch.

``akmc_tpu`` runs a superstep as one executable (``_step_fused``: the fields
and the event loop in one ``jax.jit``, ``akmc_tpu/models/vcm.py:620-632``) and
k supersteps as another (``_step_multi``, a ``lax.scan`` over the fused step
with a running cursor into one buffer of k windows of draws, ``:773-842``);
each returns one small vector of diagnostics (``_pack_diag``), the only value
the host reads. ``SuperstepProgram`` is their counterpart. Its body runs
``VCMModel._fields`` (charges, the K solve, the pairwise potential, the rate
table) and the serial event loop k times, with every loop a
``device_loop.while_loop`` (the K-CG's and the event loop's), and packs per
superstep

    [n_events, draws_used, event_time, done, cg_iterations, q_ovf, v_ovf, c_ovf]

(``_pack_diag``'s order) followed by what the loops recorded (passes, live
steps, launches, K-solve iterations) into one vector. On a card the body is
captured once into a ``torch.cuda.CUDAGraph`` whose loops are conditional
while nodes, and a dispatch is: copy the inputs in (state tensors, ``Vd``,
the window of draws: copies, not reads), one replay, one read of that
vector. On the CPU the same body runs eagerly, its while loops reading their
flags. A capture that fails raises; nothing falls back to the host-driven
loops.

The program owns its input tensors and, on a card, its outputs (the
graph's): ``run`` hands out copies of the state outputs, and the rate table,
event types and rate scale as they are, for an events-only continuation
before the next run. Which caps, chunk and options it was built for is the
caller's key (``VCMModel._superstep_program``).

``ProductionProgram`` is the same for the production supersteps,
``akmc_tpu``'s ``_step_native`` and ``_step_b`` (``vcm.py:1048-1058``,
``:1166-1198``): the warm start ``pb + k_extrap (pb - pb_prev2)`` (batched),
``_fields``, the superstep's ``split(key)`` and the native or batched event
loop as a while loop that draws inside its body from the threefry key
(``ops/threefry.py::draw_step``, the kernel ``csrc/threefry.cu`` on a card),
packed as ``akmc_tpu`` packs it (``vcm.py:1186-1197``)

    [n_events, n_batches, event_time, done, cg_iterations, q_ovf, v_ovf,
     c_ovf, n_cut_conflict, n_cut_mass]

(native: draws used in place of batches, no cuts), then the loops'
recordings. ``Vd``, ``mass_eps`` and ``k_extrap`` are 0-d tensors of the
program, so one capture serves every value; the state, ``pb_prev2`` and the
key are copied in.

The deck modes and the per-bias CB edge run as programs too, the
counterparts of ``akmc_tpu``'s ``_fields_jit``, ``_events_only_jit`` and
``_cb_jit`` (``vcm.py:457-460``, ``:1477-1498``): ``FieldsProgram`` (``_fields``
with the K-CG a while loop; ``[cg_iterations, q_ovf, v_ovf, c_ovf]``),
``EventsOnlyProgram`` (the rate table on the state's stale charge and summed
potential, then the serial loop on one window; ``[n_events, draws_used,
event_time, done]``) and ``CbEdgeProgram`` (``solve_cb_edge`` with its CG a
while loop; ``[cg_iterations]``), each followed by the loops' recordings.

With the model's ``spans`` on, every program also owns a span table
(``runtime/profiling.py``): the body zeroes it, stamps ``superstep`` and the
module spans of the code it runs, and records it after the diagnostics, so
that the one read of a run brings the dispatch's device spans
(``last_spans``); a run stamps the dispatch's anchor before its replay and
times its host phases.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import torch

from akmc_tpu_torch.ops import device_loop
from akmc_tpu_torch.ops import events
from akmc_tpu_torch.ops import threefry
from akmc_tpu_torch.ops.events import _BatchedProgram, _pack_code, _SerialProgram, _unpack_code
from akmc_tpu_torch.runtime import profiling

DIAG = 8     # entries per superstep of the packed diagnostics
PRODUCTION_DIAG = 10     # the production supersteps' (akmc_tpu's _step_b's)
FULL_DIAG = 12     # the full-physics supersteps' (akmc_tpu's _pack_diag_full)
FIELDS_DIAG = 4    # the fields-only call's: [cg_iterations, q_ovf, v_ovf, c_ovf]
EVENTS_DIAG = 4    # the events-only call's: [n_events, draws_used, event_time, done]
MAX_BATCHES = 1 << 14    # the batched loop's cap (run_event_loop_batched's default)
MAX_EVENTS = 1 << 20     # the native loop's (run_event_loop_native's default)


class _Program:
    """A body that reads nothing back, captured once on a card and run as
    one replay and one host read (eagerly on the CPU). ``KEEP``: outputs
    handed out as the program's own tensors rather than copies. ``LABEL``
    names its host spans (``akmc.<kind>.<phase>``).

    With the model's ``spans`` on, the program owns a span table
    (``runtime/profiling.py::SpanTable``, allocated here, before any
    capture): ``body`` zeroes it, opens ``superstep`` around the subclass's
    ``_body`` and records the table with the diagnostics, so the one read
    of a run brings ``last_spans``. With spans off ``body`` is the
    subclass's body and its pack, node for node."""

    KEEP = ()
    LABEL = "akmc.program"

    def _init_program(self, model) -> None:
        self.model = model
        self.device = model.device
        self.graph = None
        self.captured: Tuple[Dict[str, torch.Tensor], torch.Tensor, device_loop.Recording] = None
        self.capture_s = 0.0     # host seconds of the warm run, capture, instantiation, first launch
        self.runs = 0
        self.bound: List[tuple] = []     # what the graph binds from outside its pools
        self.spans = profiling.SpanTable(self.device) if model.spans else None
        self.last_spans: Dict[str, dict] = {}

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The program's work on the loaded inputs: (outputs, the packed
        diagnostics). Reads nothing back."""
        raise NotImplementedError

    def body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """``_body`` and its spans, then the diagnostics followed by what was
        recorded (run it inside ``device_loop.recording``): (outputs, the
        packed vector)."""
        rec = device_loop._RECORDING
        table = self.spans
        with profiling.spanning(table):
            if table is not None:
                table.reset()
            with profiling.span("superstep"):
                out, diag = self._body()
        if table is not None:
            device_loop.record(table.tensors(), self._read_spans)
        return out, torch.cat([diag, *rec.pack()])

    def _read_spans(self, values) -> None:
        self.last_spans = self.spans.read(values)

    def _capture(self) -> None:
        """Warm the body once eagerly on a side stream (its counts dropped and
        the fused CG's running total kept), then capture it into a CUDA graph
        with the cyclic collector off (a dropped graph freed inside the
        capture would invalidate it) and launch it once, uncounted."""
        from akmc_tpu_torch.solvers import dia_cg

        t0 = time.perf_counter()
        dev = self.device
        with dia_cg.iterations_total_kept(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), device_loop.recording(device_loop.Recording()):
                self.body()
            torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        rec = device_loop.Recording()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with device_loop.tracing_bindings(dev) as bound, torch.cuda.graph(graph), \
                    device_loop.refuse_syncs(), device_loop.recording(rec):
                out, stats = self.body()
        finally:
            if collecting:
                gc.enable()
        self.bound = bound
        # one launch now, whose counts are dropped: a graph's first launch
        # uploads it, which belongs to the capture's cost, not a dispatch's
        with dia_cg.iterations_total_kept(dev):
            graph.replay()
        torch.cuda.synchronize(dev)
        self.graph, self.captured = graph, (out, stats, rec)
        self.capture_s = time.perf_counter() - t0

    def capture(self) -> None:
        """Capture the program on the loaded inputs (no-op on the CPU or
        when captured)."""
        if self.device.type == "cuda" and self.graph is None:
            self._capture()

    def run(self, host: "profiling.HostSpans" = None
            ) -> Tuple[Dict[str, torch.Tensor], List[float]]:
        """One run on the loaded inputs: (outputs, the packed vector as
        read). The one host read of the dispatch; the recorded counts are
        applied (the entries after the first ``self.n_diag``). The outputs
        but ``KEEP`` are copies: the next run writes the program's own (the
        graph's, or the loops' buffers). With spans on, the anchor stamp
        goes first, and ``host`` times the ``launch`` (the replay, or on the
        CPU the eager body), the ``read`` and the ``unpack``."""
        if self.device.type == "cuda":
            self.capture()
            if self.spans is not None:
                self.spans.stamp_anchor()
            with profiling.host_span(host, "launch"):
                self.graph.replay()
            out, stats, rec = self.captured
        else:
            rec = device_loop.Recording()
            if self.spans is not None:
                self.spans.stamp_anchor()
            with profiling.host_span(host, "launch"), device_loop.recording(rec):
                out, stats = self.body()
        with profiling.host_span(host, "read"):
            vals = stats.tolist()
        self.runs += 1
        with profiling.host_span(host, "unpack"):
            rec.apply(vals[self.n_diag:])
            out = {name: (t if name in self.KEEP else t.clone()) for name, t in out.items()}
        return out, vals[: self.n_diag]


class SuperstepProgram(_Program):
    """k serial supersteps of ``model`` on one window buffer of k * ``chunk``
    draws, each step's window starting where the previous step stopped
    drawing. ``carry``: the banded K solve's carried residual, fresh in step
    1 and rebased in steps 2..k (``k_carry_residual``)."""

    KEEP = ("P", "etype", "ln_S")
    ROW = DIAG      # diagnostics a superstep
    LABEL = "akmc.superstep"

    def __init__(self, model, state, k: int, chunk: int, carry: bool):
        self._init_program(model)
        self.k, self.chunk, self.carry = k, chunk, carry
        self.n_diag = self.ROW * k
        dev = self.device
        t = model.tables
        # inputs, copied in before each run
        self.element = state.element.clone()
        self.charge = state.charge.clone()
        self.pb = state.potential_boundary.clone()
        self.T_bg = state.T_bg.clone()
        self.kmc_time = state.kmc_time.clone()
        self.Vd = torch.zeros((), dtype=torch.float64, device=dev)
        nk = events.SERIAL_NODE_K if dev.type == "cuda" else 1
        shape = tuple(t.act_neigh.shape)
        self.loop = _SerialProgram(
            torch.zeros(shape, dtype=torch.float64, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev),
            _pack_code(self.element, self.charge),
            (t.act_neigh, t.act_idx, t.abs2act, t.act_zero_rows), model.params.freq,
            chunk, False, model.rate_normalize, model._incremental_select(), nk,
            rand_len=k * chunk, nested=True)
        self.staging = (torch.zeros(k * chunk, dtype=torch.float64, pin_memory=True)
                        if dev.type == "cuda" else None)

    # ------------------------------------------------------------------
    def load(self, state, Vd: float, window) -> None:
        """Copy one dispatch's inputs in: the state, the bias and the window
        of draws (numpy, k * chunk of them; through a pinned buffer on a card,
        which the previous run's read has freed)."""
        self.element.copy_(state.element)
        self.charge.copy_(state.charge)
        self.pb.copy_(state.potential_boundary)
        self.T_bg.copy_(state.T_bg)
        self.kmc_time.copy_(state.kmc_time)
        self.Vd.fill_(float(Vd))
        win = torch.from_numpy(window)
        dst = self.loop.rand[: win.shape[0]]
        if self.staging is None:
            dst.copy_(win)
        else:
            self.staging[: win.shape[0]].copy_(win)
            dst.copy_(self.staging[: win.shape[0]], non_blocking=True)

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The k supersteps on the loaded inputs: (outputs, the diagnostics
        of every step). Reads nothing back."""
        m, loop = self.model, self.loop
        inv_freq = 1.0 / m.params.freq
        element, charge, pb, kmc = self.element, self.charge, self.pb, self.kmc_time
        cursor = torch.zeros((), dtype=torch.int64, device=self.device)
        k_carry = "init" if self.carry else None
        f64 = torch.float64
        rows: List[torch.Tensor] = []
        for _ in range(self.k):
            fr = m._fields(element, charge, pb, self.T_bg, self.Vd, k_carry)
            loop.load(element, fr.charge, fr.P, fr.etype, fr.ln_S, None)
            loop.base.copy_(cursor)
            loop.run_nested()
            element, charge, ev_time = loop.results(element, fr.charge, fr.P)
            draws = loop.cnt.clone()
            cursor = cursor + draws
            kmc = kmc + ev_time
            rows.append(torch.stack([
                loop.n_ev.to(f64), draws.to(f64), ev_time, (ev_time >= inv_freq).to(f64),
                torch.as_tensor(fr.cg_iterations, device=self.device).to(f64),
                fr.q_overflow.to(f64), fr.v_overflow.to(f64), fr.c_overflow.to(f64)]))
            pb = fr.potential_boundary
            k_carry = fr.k_carry if self.carry else None
        out = dict(element=element, charge=charge, potential_boundary=pb,
                   potential_charge=fr.potential_sum, kmc_time=kmc, event_time=ev_time,
                   P=fr.P, etype=fr.etype, ln_S=fr.ln_S)
        return out, torch.stack(rows).reshape(-1)

    def run(self, host: "profiling.HostSpans" = None
            ) -> Tuple[Dict[str, torch.Tensor], List[List[float]]]:
        """One run on the loaded inputs: (outputs, each step's ``ROW``
        diagnostics as read). ``P``, ``etype`` and ``ln_S`` are the program's
        until its next run."""
        out, vals = super().run(host)
        r = self.ROW
        return out, [vals[r * i: r * (i + 1)] for i in range(self.k)]


class ProductionProgram(_Program):
    """One production superstep of ``model``: ``superstep_native`` (``batch``
    0) or ``superstep_native_batched`` with ``batch`` candidates and
    ``clock_f32``'s clocks, drawing from the threefry key it is given. The
    event loop runs ``events.SERIAL_NODE_K`` events or
    ``events.BATCHED_NODE_K`` batches per pass of its while node. ``run``
    gives (outputs, the 10 diagnostics); ``out["key"]`` is the key moved on
    by the superstep's split."""

    LABEL = "akmc.production"

    def __init__(self, model, state, batch: int, clock_f32: bool):
        self._init_program(model)
        self.batch, self.clock_f32 = batch, clock_f32
        self.n_diag = PRODUCTION_DIAG
        dev = self.device
        t = model.tables
        f64 = dict(dtype=torch.float64, device=dev)
        # inputs, copied in before each run
        self.element = state.element.clone()
        self.charge = state.charge.clone()
        self.pb = state.potential_boundary.clone()
        self.pb_prev2 = state.potential_boundary.clone()
        self.T_bg = state.T_bg.clone()
        self.Vd = torch.zeros((), **f64)
        self.mass_eps = torch.zeros((), **f64)
        self.k_extrap = torch.zeros((), **f64)
        self.key_in = torch.zeros(2, dtype=torch.int64, device=dev)
        # the loop's cap on batches or events: MAX_BATCHES / MAX_EVENTS, but
        # 1 while the program is captured (``_capture``)
        self.max_steps = torch.full((), MAX_BATCHES if batch else MAX_EVENTS,
                                    dtype=torch.int64, device=dev)
        # the key the body splits: set from ``key_in`` by the body itself, so
        # that a run (the capture's warm run and first launch too) leaves
        # its inputs as they were
        self.key = threefry.key_state(device=dev)
        shape = tuple(t.act_neigh.shape)
        P = torch.zeros(shape, **f64)
        etype = torch.zeros(shape, dtype=torch.int32, device=dev)
        if batch:
            self.loop = _BatchedProgram(
                self.element, self.charge, P, etype, (t.act_neigh, t.act_idx, t.abs2act),
                model.params.freq, batch, torch.float32 if clock_f32 else torch.float64,
                model.rate_normalize, events.BATCHED_NODE_K, keyed=True,
                nested=True)
        else:
            self.loop = _SerialProgram(
                P, etype, _pack_code(self.element, self.charge),
                (t.act_neigh, t.act_idx, t.abs2act, t.act_zero_rows), model.params.freq,
                0, True, model.rate_normalize, False, events.SERIAL_NODE_K,
                keyed=True, nested=True)

    def load(self, state, Vd: float, key: torch.Tensor, pb_prev2=None,
             mass_eps: float = 1e-3, k_extrap: float = 0.0) -> None:
        """Copy one superstep's inputs in: the state, the bias, the key
        (``KeyDraws.key``), the warm start's ``pb_prev2`` (None: the state's
        boundary potential, the plain warm start) and the loop's knobs."""
        self.element.copy_(state.element)
        self.charge.copy_(state.charge)
        self.pb.copy_(state.potential_boundary)
        self.pb_prev2.copy_(state.potential_boundary if pb_prev2 is None else pb_prev2)
        self.T_bg.copy_(state.T_bg)
        self.Vd.fill_(float(Vd))
        self.mass_eps.fill_(float(mass_eps))
        self.k_extrap.fill_(float(k_extrap))
        self.key_in.copy_(key)

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The superstep on the loaded inputs: (outputs, the diagnostics).
        Reads nothing back."""
        m, loop, dev = self.model, self.loop, self.device
        f64 = torch.float64
        pb = self.pb
        if self.batch:
            pb = pb + self.k_extrap * (pb - self.pb_prev2)
        fr = m._fields(self.element, self.charge, pb, self.T_bg, self.Vd)
        with profiling.span("key_split"):
            self.key[threefry.KEY].copy_(self.key_in)
            threefry.draw_step(self.key)          # key, sub = split(key): sub in key[4:6]
        sub = self.key[4:6]
        if self.batch:
            loop.load(self.element, fr.charge, fr.P, fr.etype, fr.ln_S, self.mass_eps,
                      self.max_steps, key=sub)
            loop.run_nested()
            n = self.element.shape[0]
            element, charge = loop.element_x[:n], loop.charge_x[:n]
            n_ev, ev_time, done = loop.n_ev, loop.ev_time, loop.done
            counts = (loop.n_b, loop.n_cc, loop.n_cm)
        else:
            loop.load(self.element, fr.charge, fr.P, fr.etype, fr.ln_S, None,
                      max_events=self.max_steps, key=sub)
            loop.run_nested("native")
            element, charge = _unpack_code(loop.code, self.element.dtype, self.charge.dtype)
            n_ev, ev_time = loop.n_ev, loop.ev_time
            done = ev_time >= loop.inv_freq
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            counts = (2 * n_ev, zero, zero)
        diag = torch.stack([
            n_ev.to(f64), counts[0].to(f64), ev_time.to(f64), done.to(f64),
            torch.as_tensor(fr.cg_iterations, device=dev).to(f64),
            fr.q_overflow.to(f64), fr.v_overflow.to(f64), fr.c_overflow.to(f64),
            counts[1].to(f64), counts[2].to(f64)])
        out = dict(element=element, charge=charge, potential_boundary=fr.potential_boundary,
                   potential_charge=fr.potential_sum, event_time=ev_time,
                   key=self.key[threefry.KEY])
        return out, diag

    def _capture(self) -> None:
        """``_Program._capture`` with the loop cut to one batch or event: the
        warm run still runs every kernel of the body once, and neither it
        nor the first launch runs a whole superstep."""
        full = self.max_steps.clone()
        self.max_steps.fill_(1)
        try:
            super()._capture()
        finally:
            self.max_steps.copy_(full)



class FullProgram(SuperstepProgram):
    """k full-physics supersteps of ``model``, ``akmc_tpu``'s ``_step_full``
    (``vcm.py:1557-1596``; k > 1: ``superstep_full_multi``'s ``lax.scan``, a
    running cursor into one buffer of k windows of ``chunk`` draws). Each
    step runs, in the reference's order, ``_fields``, the current and the
    dissipated power on this step's charge (``VCMModel._power``: the W-block
    build with its energy loops as while loops, the power CG as a while
    loop), the serial event loop as a while loop, and the heat model over the
    step's event time (``VCMModel._heat``: the local model's transient steps
    a while loop, its steady solve under a ``device_loop.cond``), and packs
    ``_pack_diag_full``'s entries

        [n_events, draws_used, event_time, done, cg_iterations, q_ovf,
         v_ovf | pw_ovf, I_macro, T_bg, power_cg_iterations, P_tot, c_ovf]

    followed, after the k steps, by the loops' recordings. ``Vd`` and
    ``rtol_scale`` are 0-d tensors of the program, so one capture serves
    every bias and both of the driver's power tolerances; the state, the
    power solve's warm start ``m`` and the window are copied in. ``run``
    gives (outputs, each step's 12 diagnostics): the state after k steps,
    the last step's ``site_power``, ``m``, and the last step's rate table,
    event types and rate scale (the program's until its next run) for an
    events-only continuation."""

    ROW = FULL_DIAG
    LABEL = "akmc.full"

    def __init__(self, model, state, k: int, chunk: int):
        super().__init__(model, state, k, chunk, False)
        dev = self.device
        self.cb_edge = state.cb_edge.clone()
        self.temperature = state.temperature.clone()
        self.m_prev = torch.zeros(model.n_atom + 2, dtype=torch.float64, device=dev)
        self.rtol_scale = torch.ones((), dtype=torch.float64, device=dev)
        if model.params.solve_heating_local and dev.type == "cuda":
            model._build_heat_program(state)

    def load(self, state, Vd: float, window, m_prev: torch.Tensor, rtol_scale) -> None:
        """Copy one dispatch's inputs in: ``SuperstepProgram.load``'s, the CB
        edge, the site temperatures, the power solve's warm start and its
        tolerance multiplier."""
        super().load(state, Vd, window)
        self.cb_edge.copy_(state.cb_edge)
        self.temperature.copy_(state.temperature)
        self.m_prev.copy_(m_prev)
        self.rtol_scale.fill_(float(rtol_scale))

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The k steps on the loaded inputs: (outputs, the diagnostics).
        Reads nothing back."""
        m, loop, dev = self.model, self.loop, self.device
        inv_freq = 1.0 / m.params.freq
        f64 = torch.float64
        element, charge, pb, kmc = self.element, self.charge, self.pb, self.kmc_time
        T_bg, temp, m_prev = self.T_bg, self.temperature, self.m_prev
        cursor = torch.zeros((), dtype=torch.int64, device=dev)
        rows: List[torch.Tensor] = []
        for _ in range(self.k):
            fr = m._fields(element, charge, pb, T_bg, self.Vd)
            I_macro, site_power, m_prev, pow_iters, pw_ovf = m._power(
                element, fr.charge, self.cb_edge, m_prev, self.Vd, self.rtol_scale)
            loop.load(element, fr.charge, fr.P, fr.etype, fr.ln_S, None)
            loop.base.copy_(cursor)
            loop.run_nested()
            element, charge, ev_time = loop.results(element, fr.charge, fr.P)
            draws = loop.cnt.clone()
            cursor = cursor + draws
            kmc = kmc + ev_time
            T_bg, temp = m._heat(T_bg, temp, site_power, element, ev_time)
            rows.append(torch.stack([
                loop.n_ev.to(f64), draws.to(f64), ev_time, (ev_time >= inv_freq).to(f64),
                torch.as_tensor(fr.cg_iterations, device=dev).to(f64),
                fr.q_overflow.to(f64), (fr.v_overflow | pw_ovf).to(f64), I_macro,
                T_bg.to(f64), torch.as_tensor(pow_iters, device=dev).to(f64),
                torch.sum(site_power), fr.c_overflow.to(f64)]))
            pb = fr.potential_boundary
        out = dict(element=element, charge=charge, potential_boundary=pb,
                   potential_charge=fr.potential_sum, kmc_time=kmc, event_time=ev_time,
                   temperature=temp, T_bg=T_bg, power=site_power, m=m_prev,
                   P=fr.P, etype=fr.etype, ln_S=fr.ln_S)
        return out, torch.stack(rows).reshape(-1)


class FieldsProgram(_Program):
    """The fields of one state at one bias, ``akmc_tpu``'s ``_fields_jit``
    (``fields_only``, ``perturb_structure = 0``): ``VCMModel._fields`` with
    the K-CG a while loop (on the DIA operator the fused kernel's one
    cooperative launch and the matvec's, both recorded by the capture),
    packed as ``[cg_iterations, q_ovf, v_ovf, c_ovf]`` and the loops'
    recordings. ``Vd`` is a 0-d tensor of the program; the state is copied
    in. ``run`` gives the charge, the boundary and the summed potential."""

    LABEL = "akmc.fields"

    def __init__(self, model, state):
        self._init_program(model)
        self.n_diag = FIELDS_DIAG
        self.element = state.element.clone()
        self.charge = state.charge.clone()
        self.pb = state.potential_boundary.clone()
        self.T_bg = state.T_bg.clone()
        self.Vd = torch.zeros((), dtype=torch.float64, device=self.device)

    def load(self, state, Vd: float) -> None:
        self.element.copy_(state.element)
        self.charge.copy_(state.charge)
        self.pb.copy_(state.potential_boundary)
        self.T_bg.copy_(state.T_bg)
        self.Vd.fill_(float(Vd))

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The fields on the loaded inputs: (outputs, the diagnostics).
        Reads nothing back."""
        f64 = torch.float64
        fr = self.model._fields(self.element, self.charge, self.pb, self.T_bg, self.Vd)
        diag = torch.stack([torch.as_tensor(fr.cg_iterations, device=self.device).to(f64),
                            fr.q_overflow.to(f64), fr.v_overflow.to(f64),
                            fr.c_overflow.to(f64)])
        out = dict(charge=fr.charge, potential_boundary=fr.potential_boundary,
                   potential_sum=fr.potential_sum)
        return out, diag


class EventsOnlyProgram(SuperstepProgram):
    """The event step on a state's stale charge and summed potential,
    ``akmc_tpu``'s ``_events_only_jit`` (``superstep_events_only``,
    ``solve_potential = 0``): the rate table (``VCMModel._build_rates``), then
    the serial loop as a while loop on one window of ``chunk`` draws, packed
    as ``[n_events, draws_used, event_time, done]`` and the loops'
    recordings. ``run`` gives the new element and charge, the event time,
    and the mutated rate table, event types and rate scale (the program's
    until its next run) for an events-only continuation."""

    ROW = EVENTS_DIAG
    LABEL = "akmc.events_only"

    def __init__(self, model, state, chunk: int):
        super().__init__(model, state, 1, chunk, False)
        self.pc = state.potential_charge.clone()

    def load(self, state, window) -> None:
        """Copy the state and the window of draws in (no bias: nothing is solved)."""
        super().load(state, 0.0, window)
        self.pc.copy_(state.potential_charge)

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        m, loop = self.model, self.loop
        f64 = torch.float64
        with profiling.span("rates"):
            P, etype, ln_S = m._build_rates(self.element, self.charge, self.pc, self.T_bg)
        loop.load(self.element, self.charge, P, etype, ln_S, None)
        loop.base.zero_()
        loop.run_nested()
        element, charge, ev_time = loop.results(self.element, self.charge, P)
        diag = torch.stack([loop.n_ev.to(f64), loop.cnt.to(f64), ev_time,
                            (ev_time >= 1.0 / m.params.freq).to(f64)])
        out = dict(element=element, charge=charge, event_time=ev_time, P=P, etype=etype,
                   ln_S=ln_S)
        return out, diag


class CbEdgeProgram(_Program):
    """The conduction-band edge at one bias, ``akmc_tpu``'s ``_cb_jit``
    (``update_cb_edge``, once per bias point): ``solve_cb_edge``'s system
    and its ``symscaled_cg`` as a while loop (the span ``cb_edge``), packed
    as ``[cg_iterations]`` and the loop's recordings. ``Vd`` is a 0-d tensor
    of the program; the element, charge and previous edge are copied in."""

    LABEL = "akmc.cb_edge"

    def __init__(self, model, state):
        self._init_program(model)
        self.n_diag = 1
        self.element = state.element.clone()
        self.charge = state.charge.clone()
        self.cb_prev = state.cb_edge.clone()
        self.Vd = torch.zeros((), dtype=torch.float64, device=self.device)

    def load(self, state, Vd: float) -> None:
        self.element.copy_(state.element)
        self.charge.copy_(state.charge)
        self.cb_prev.copy_(state.cb_edge)
        self.Vd.fill_(float(Vd))

    def _body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        from akmc_tpu_torch.solvers.poisson import solve_cb_edge

        m = self.model
        p, t = m.params, m.tables
        with profiling.span("cb_edge"):
            cb, res = solve_cb_edge(self.element, self.charge, self.cb_prev, t.k_neigh_idx,
                                    t.metal_or_edge, self.Vd, p.high_G * 100000, p.low_G,
                                    p.num_atoms_first_layer, graphs=m.cg_graphs)
        it = torch.as_tensor(res.iterations, device=self.device).to(torch.float64).reshape(1)
        return {"cb_edge": cb}, it
