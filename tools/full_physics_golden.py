"""The full-physics golden of ``decks/iv_sweep_5nm.txt`` on the synthesized
n_yz = 24 crossbar (58,752 slots), and akmc_tpu's own spreads that the port's
tolerances are set from.

Each part runs ``akmc_tpu`` on the CPU and writes ``W/<part>.json``; the parts
are independent, so they may run as separate processes side by side:

    JAX_PLATFORMS=cpu python tools/full_physics_golden.py W --part main
    ... --part gather | wkb_f32 | heating_global | heating_local | rtol
    python tools/full_physics_golden.py W --assemble \
        > akmc_tpu_torch/golden/iv_sweep_5nm_n24_full.json

main            ``python -m akmc_tpu.runtime.driver decks/iv_sweep_5nm.txt
                --synthesize-crossbar 24 --full-physics --dia-pallas``: the
                whole sweep, power CG tolerance "auto" (the golden record);
gather          the same sweep with ``solve_power``'s gather operator in place
                of the atom band (``build_power_band`` answers None, as for a
                structure too wide for a band): akmc_tpu's own spread of
                ``I_macro`` and ``P_tot`` between two operators;
wkb_f32         the first three supersteps with ``--wkb-f32``: the spread of
                f32 WKB planes against f64 on the same supersteps;
heating_global  four supersteps of the deck with ``solve_heating_global = 1``
heating_local   and with ``solve_heating_local = 1`` (deck copies from
                ``akmc_tpu_torch/runtime/synth_deck.py::write_heating_deck``),
                stepped as the driver steps them, with ``T_bg`` and the
                temperature entries that left the background temperature;
rtol            one power solve on the sweep's initial state at 8 V with
                ``rtol_scale`` 1, 1e-2 and 1e-4: ``I_macro``, ``P_tot`` and
                the CG's iterations at each, through the atom band and,
                as the yardstick, through the gather operator;
synth_rtol      the same on the disordered 5 nm-sized stand-in
                (``synthetic_stack(n_yz=24)``, N = 31,088, the deck of
                ``akmc_tpu_torch/runtime/synth_deck.py``): a structure without
                placeholder slots, whose CB edge is finite, so that its WKB
                blocks carry tunneling and its current is resolved;
synth_sweep     the first three supersteps of that deck through the driver
                with ``--full-physics``;
synth_sweep_gather  the same with the gather operator: akmc_tpu's own spread
                on those supersteps.

The assembled file is the main record (``akmc_tpu_torch.runtime.golden``'s
format, full-physics keys included) with the other parts under ``parts`` and
the spreads under ``spread``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
DECK = os.path.join(HERE, "decks", "iv_sweep_5nm.txt")
N_YZ = 24
PARTS = ("main", "gather", "wkb_f32", "heating_global", "heating_local", "rtol",
         "synth_rtol", "synth_sweep", "synth_sweep_gather")
SYNTH_SUPERSTEPS = 3
HEATING_SUPERSTEPS = 4
WKB_F32_SUPERSTEPS = 3
RTOL_VD = 8.0
RTOL_SCALES = (1.0, 1e-2, 1e-4)


def driver_record(workdir: str, **options) -> dict:
    from akmc_tpu.runtime import driver

    from akmc_tpu_torch.runtime import golden

    driver.run(DECK, workdir=workdir, synthesize_crossbar=N_YZ, committed_parity=False,
               dia_pallas=True, **options)
    return golden.summarize(workdir)


def crossbar_model(p_deck, **model_options):
    """akmc_tpu's model and first state of the deck on the synthesized
    crossbar, built as its driver builds them."""
    from akmc_tpu.lattice import build_lattice
    from akmc_tpu.models.crossbar import mask_null_slots, synthesize_deck_structure
    from akmc_tpu.models.vcm import VCMModel
    from akmc_tpu.rng import ReferenceRNG
    from akmc_tpu.state import make_device_state, make_substoichiometric

    p, element, x, y, z = synthesize_deck_structure(p_deck, N_YZ)
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p)
    mask_null_slots(lat)
    rate_normalize = max(abs(v) for v in p.V_switch) >= 8.0
    model = VCMModel(p, lat, rate_normalize=rate_normalize, dia_pallas=True, **model_options)
    return model, make_device_state(lat, p.background_temp)


def heating_record(workdir: str, kind: str) -> dict:
    """The first HEATING_SUPERSTEPS supersteps of the heating deck, stepped as
    ``akmc_tpu.runtime.driver.run`` steps a full-physics sweep."""
    from akmc_tpu.config import KMCParameters
    from akmc_tpu.rng import BufferedStream, ReferenceRNG

    from akmc_tpu_torch.runtime.synth_deck import write_heating_deck

    deck = write_heating_deck(DECK, workdir, kind)
    p = KMCParameters.from_file(deck)
    model, state = crossbar_model(p)
    stream = BufferedStream(ReferenceRNG(p.rnd_seed_kmc))
    rows, m_warm, last_I = [], None, None
    for Vd, t_bias in zip(p.V_switch, p.t_switch):
        state = model.update_cb_edge(state, Vd)
        kmc_time = 0.0
        state = state._replace(kmc_time=state.kmc_time * 0.0)
        while kmc_time < t_bias and len(rows) < HEATING_SUPERSTEPS:
            rscale = 1e-2 if last_I is not None and abs(last_I) < 1e-9 else 1.0
            state, stats, m_warm = model.superstep_full(state, Vd, stream, m_prev=m_warm,
                                                        rtol_scale=rscale)
            last_I = stats["I_macro"]
            kmc_time += stats["event_time"]
            rows.append({"bias": Vd, "kmc_time": kmc_time, "power_rtol_scale": rscale,
                         **{k: stats[k] for k in ("n_events", "cg_iterations", "I_macro",
                                                  "P_tot", "T_bg", "power_cg_iterations")}})
            print(f"[heating {kind} Vd={Vd}] {rows[-1]}", flush=True)
        if len(rows) >= HEATING_SUPERSTEPS:
            break
    temp = np.asarray(state.temperature)
    moved = np.nonzero(temp != p.background_temp)[0]
    return {
        "deck": f"decks/iv_sweep_5nm.txt with solve_heating_{kind} = 1 "
                "(akmc_tpu_torch/runtime/synth_deck.py::write_heating_deck)",
        "supersteps": rows,
        "final_elements": "".join(str(int(e)) for e in np.asarray(state.element)),
        "final_T_bg": float(state.T_bg),
        # the temperature entries that left the background temperature
        "temperature_moved": [[int(i), float(temp[i])] for i in moved],
        "temperature_max_abs_dev": float(np.abs(temp - p.background_temp).max()),
    }


def synth_model(workdir: str, **model_options):
    """akmc_tpu's model and first state of the disordered stand-in's deck,
    built as its driver builds them; and the deck's path."""
    from akmc_tpu.config import KMCParameters
    from akmc_tpu.lattice import build_lattice
    from akmc_tpu.models.vcm import VCMModel
    from akmc_tpu.rng import ReferenceRNG
    from akmc_tpu.runtime.driver import load_structure
    from akmc_tpu.state import make_device_state, make_substoichiometric

    from akmc_tpu_torch.runtime.synth_deck import write_synth_deck

    deck = write_synth_deck(DECK, workdir, N_YZ)
    p = KMCParameters.from_file(deck)
    element, x, y, z = load_structure(p, workdir)
    element = make_substoichiometric(element, p.initial_vacancy_concentration,
                                     ReferenceRNG(p.rnd_seed))
    lat = build_lattice(element, x, y, z, p)
    rate_normalize = max(abs(v) for v in p.V_switch) >= 8.0
    model = VCMModel(p, lat, rate_normalize=rate_normalize, **model_options)
    return model, make_device_state(lat, p.background_temp), deck


def rtol_record(synth_dir: str | None = None) -> dict:
    """One power solve on the sweep's first state at RTOL_VD at each scale
    (the crossbar's, or with ``synth_dir`` the disordered stand-in's)."""
    from akmc_tpu.config import KMCParameters

    if synth_dir:
        model, state, _ = synth_model(synth_dir, pair_table_budget=0)
    else:
        model, state = crossbar_model(KMCParameters.from_file(DECK), pair_table_budget=0)
    state = model.update_cb_edge(state, RTOL_VD)
    out = {}
    for operator in ("band", "gather"):
        if operator == "gather":
            # the model's band taken away: solve_power's gather operator
            model._power_band, model._power_band_built = None, True
        out[operator] = []
        for scale in RTOL_SCALES:
            s, I_macro, _, iters = model.update_power(state, RTOL_VD, rtol_scale=scale)
            out[operator].append({"rtol_scale": scale, "I_macro": I_macro,
                                  "P_tot": float(np.asarray(s.power).sum()),
                                  "power_cg_iterations": iters})
            print(f"[rtol {operator}] {out[operator][-1]}", flush=True)
    return {"Vd": RTOL_VD, "state": "the sweep's first state after update_cb_edge",
            "solves": out["band"], "solves_gather": out["gather"]}


def run_part(workdir: str, part: str) -> dict:
    os.makedirs(workdir, exist_ok=True)
    sub = os.path.join(workdir, part)
    if part == "main":
        return driver_record(sub)
    if part == "gather":
        from akmc_tpu.models import vcm

        vcm.build_power_band = lambda *args, **kwargs: None
        return driver_record(sub)
    if part == "wkb_f32":
        return driver_record(sub, wkb_f32=True, max_supersteps=WKB_F32_SUPERSTEPS)
    if part in ("heating_global", "heating_local"):
        return heating_record(sub, part.split("_")[1])
    if part == "rtol":
        return rtol_record()
    if part == "synth_rtol":
        return rtol_record(sub)
    if part in ("synth_sweep", "synth_sweep_gather"):
        from akmc_tpu.models import vcm
        from akmc_tpu.runtime import driver

        from akmc_tpu_torch.runtime import golden
        from akmc_tpu_torch.runtime.synth_deck import write_synth_deck

        if part == "synth_sweep_gather":
            vcm.build_power_band = lambda *args, **kwargs: None
        deck = write_synth_deck(DECK, sub, N_YZ)
        driver.run(deck, workdir=os.path.join(sub, "out"), committed_parity=False,
                   max_supersteps=SYNTH_SUPERSTEPS)
        return golden.summarize(os.path.join(sub, "out"))
    raise ValueError(part)


def _max_rel(a: list, b: list, key: str) -> float:
    return max(abs(x[key] - y[key]) / abs(x[key]) for x, y in zip(a, b))


def assemble(workdir: str) -> dict:
    parts = {}
    for part in PARTS:
        with open(os.path.join(workdir, part + ".json")) as f:
            parts[part] = json.load(f)
    main, gather, f32 = parts.pop("main"), parts["gather"], parts["wkb_f32"]
    ms, gs = main["supersteps"], gather["supersteps"]
    spread = {
        "band_vs_gather": {
            "same_trajectory": ([(r["bias"], r["n_events"]) for r in ms]
                                == [(r["bias"], r["n_events"]) for r in gs]
                                and main["final_elements"] == gather["final_elements"]),
            "I_macro_max_rel": _max_rel(ms, gs, "I_macro"),
            "P_tot_max_rel": _max_rel(ms, gs, "P_tot"),
            "kmc_time_max_rel": _max_rel(ms, gs, "kmc_time"),
        },
        "wkb_f32_vs_f64": {
            "supersteps": len(f32["supersteps"]),
            "same_trajectory": [(r["bias"], r["n_events"]) for r in f32["supersteps"]]
            == [(r["bias"], r["n_events"]) for r in ms[: len(f32["supersteps"])]],
            "I_macro_max_rel": _max_rel(ms, f32["supersteps"], "I_macro"),
            "P_tot_max_rel": _max_rel(ms, f32["supersteps"], "P_tot"),
        },
        "synth_sweep_band_vs_gather": {
            "I_macro_max_rel": _max_rel(parts["synth_sweep"]["supersteps"],
                                        parts["synth_sweep_gather"]["supersteps"], "I_macro"),
            "P_tot_max_rel": _max_rel(parts["synth_sweep"]["supersteps"],
                                      parts["synth_sweep_gather"]["supersteps"], "P_tot"),
        },
    }
    # the gather run's per-superstep values stay; its elements equal the main's
    for part in (gather, f32, parts["synth_sweep_gather"]):
        part.pop("final_elements")
    return {**main, "command": "python -m akmc_tpu.runtime.driver decks/iv_sweep_5nm.txt "
            "--synthesize-crossbar 24 --full-physics --dia-pallas",
            "spread": spread, "parts": parts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--part", choices=PARTS)
    ap.add_argument("--assemble", action="store_true")
    ap.add_argument("--n-yz", type=int, default=24,
                    help="crossbar width (default 24; smaller for a quick trial)")
    args = ap.parse_args(argv)
    global N_YZ
    N_YZ = args.n_yz
    if args.assemble:
        json.dump(assemble(args.workdir), sys.stdout, indent=1)
        sys.stdout.write("\n")
        return
    import jax

    jax.config.update("jax_enable_x64", True)
    record = run_part(args.workdir, args.part)
    with open(os.path.join(args.workdir, args.part + ".json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
