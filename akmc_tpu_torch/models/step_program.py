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
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import torch

from akmc_tpu_torch.ops import device_loop
from akmc_tpu_torch.ops import events
from akmc_tpu_torch.ops.events import _pack_code, _SerialProgram

DIAG = 8     # entries per superstep of the packed diagnostics


class SuperstepProgram:
    """k serial supersteps of ``model`` on one window buffer of k * ``chunk``
    draws, each step's window starting where the previous step stopped
    drawing. ``carry``: the banded K solve's carried residual, fresh in step
    1 and rebased in steps 2..k (``k_carry_residual``)."""

    def __init__(self, model, state, k: int, chunk: int, carry: bool):
        self.model, self.k, self.chunk, self.carry = model, k, chunk, carry
        dev = self.device = model.device
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
            rand_len=k * chunk)
        self.staging = (torch.zeros(k * chunk, dtype=torch.float64, pin_memory=True)
                        if dev.type == "cuda" else None)
        self.graph = None
        self.captured: Tuple[Dict[str, torch.Tensor], torch.Tensor, device_loop.Recording] = None
        self.capture_s = 0.0     # host seconds of the warm run, capture, instantiation, first launch
        self.runs = 0

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

    def body(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """The k supersteps on the loaded inputs: (outputs, the packed
        diagnostics of every step). Reads nothing back; run it inside
        ``device_loop.recording``, whose entries it packs after the diagnostics."""
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
        rec = device_loop._RECORDING
        stats = torch.cat([torch.stack(rows).reshape(-1), *rec.pack()])
        return out, stats

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
            with torch.cuda.graph(graph), device_loop.refuse_syncs(), \
                    device_loop.recording(rec):
                out, stats = self.body()
        finally:
            if collecting:
                gc.enable()
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

    def run(self) -> Tuple[Dict[str, torch.Tensor], List[List[float]]]:
        """One run on the loaded inputs: (outputs, each step's 8 diagnostics
        as read). The one host read of the dispatch; the recorded counts are
        applied. On a card the state outputs are copies (the graph writes
        its own at the next run); ``P``, ``etype`` and ``ln_S`` are the
        program's until its next run."""
        if self.device.type == "cuda":
            self.capture()
            self.graph.replay()
            out, stats, rec = self.captured
        else:
            rec = device_loop.Recording()
            with device_loop.recording(rec):
                out, stats = self.body()
        vals = stats.tolist()
        self.runs += 1
        rec.apply(vals[DIAG * self.k:])
        if self.device.type == "cuda":
            out = {name: (t.clone() if name not in ("P", "etype", "ln_S") else t)
                   for name, t in out.items()}
        diag = [vals[DIAG * i: DIAG * (i + 1)] for i in range(self.k)]
        return out, diag
