"""Passes of production batched supersteps at one bias on a threefry key
(``VCMModel.superstep_native_batched`` as the driver's ``--batched-events``
calls it: the previous superstep's boundary potential as ``pb_prev2``).

Traffic keys: ``V``, ``supersteps_per_pass``, ``batch``, ``mass_eps``,
``clock_f32``, ``k_extrap``."""

from portbench import harness
from portbench.reference import events as ref_events
from portbench.reference import streams


def steps(setup, traffic: dict, seed: int, pass_index):
    from akmc_tpu_torch.ops.threefry import KeyDraws

    model, state = setup.model, setup.state0
    key_seed = harness.mix(seed, "kmc", pass_index, bits=63)
    draws = KeyDraws.seeded(key_seed, model.device)
    pb_prev2 = None
    Vd = float(traffic["V"])
    for s in range(int(traffic["supersteps_per_pass"])):
        pb_before = state.potential_boundary
        new, stats = model.superstep_native_batched(
            state, Vd, draws, batch=int(traffic["batch"]), mass_eps=float(traffic["mass_eps"]),
            clock_f32=bool(traffic["clock_f32"]), pb_prev2=pb_prev2,
            k_extrap=float(traffic["k_extrap"]))
        pb_prev2 = pb_before
        yield state, new, stats, Vd, {"key_seed": key_seed, "step_in_pass": s}
        state = new


def warm_kwargs(traffic: dict) -> dict:
    """``VCMModel.warmup``'s arguments for the shapes the mix uses."""
    return dict(batched=int(traffic["batch"]), clock_f32=bool(traffic["clock_f32"]))


def first_bias(traffic: dict) -> float:
    return float(traffic["V"])


def replay(ref, traffic: dict, element, charge, P, etype, ln_S, where: dict, dtype):
    """The step's batched race in the reference, on the step's subkey of
    the pass's key: (element, charge, events, batches, time)."""
    key = streams.key(where["key_seed"], ref.dev)
    for _ in range(int(where["step_in_pass"]) + 1):
        pair = streams.split(key)
        key, sub = pair[0], pair[1]
    return ref_events.batched(ref.table, element, charge, P, etype, ln_S,
                              float(ref.ph["freq"]), sub, int(traffic["batch"]),
                              float(traffic["mass_eps"]), clock_dtype=dtype)
