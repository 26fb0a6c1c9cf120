"""Scrape simulation logs into arrays.

Reads both the reference-compatible text logs (the same regex schema the
reference's postprocessing scripts use — plot_IV.py:26-38,
extract_data.py:17-31: "Applied Voltage =", "Current [uA]:",
"Global temperature [K]:", "KMC time is:") and the structured
metrics.jsonl, as either driver writes them. This package's own copy of
``akmc_tpu/postprocessing/extract.py``.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import List


@dataclass
class RunData:
    voltages: List[float] = field(default_factory=list)      # per bias point
    kmc_times: List[float] = field(default_factory=list)     # per superstep
    cum_times: List[float] = field(default_factory=list)     # cumulative across biases
    step_voltage: List[float] = field(default_factory=list)  # bias per superstep
    currents_uA: List[float] = field(default_factory=list)
    conductances_uS: List[float] = field(default_factory=list)
    powers_mW: List[float] = field(default_factory=list)
    temperatures_K: List[float] = field(default_factory=list)


_V_RE = re.compile(r"Applied Voltage = ([\d.eE+-]+) V")
_T_RE = re.compile(r"KMC time is: ([\d.eE+-]+)")
_I_RE = re.compile(r"Current \[uA\]: ([\d.eE+-]+)")
_G_RE = re.compile(r"Conductance \[uS\]: ([\d.eE+-]+)")
_P_RE = re.compile(r"dissipated power \[mW\]: ([\d.eE+-]+)")
_TEMP_RE = re.compile(r"Global temperature \[K\]: ([\d.eE+-]+)")


def parse_output_txt(path: str) -> RunData:
    """Scrape a run log. ``cum_times`` accumulates KMC time across bias
    points exactly like the reference scrapers do (plot_current.py:28-32:
    the running offset resets to the last accumulated time at each
    "Applied Voltage =" line, since KMC time restarts per bias point)."""
    data = RunData()
    v = float("nan")
    reset_time = 0.0
    with open(path) as f:
        for line in f:
            m = _V_RE.search(line)
            if m:
                v = float(m.group(1))
                data.voltages.append(v)
                reset_time = data.cum_times[-1] if data.cum_times else 0.0
                continue
            m = _T_RE.search(line)
            if m:
                t = float(m.group(1))
                data.kmc_times.append(t)
                data.cum_times.append(t + reset_time)
                data.step_voltage.append(v)
                continue
            m = _I_RE.search(line)
            if m:
                data.currents_uA.append(float(m.group(1)))
                continue
            m = _G_RE.search(line)
            if m:
                data.conductances_uS.append(float(m.group(1)))
                continue
            m = _P_RE.search(line)
            if m:
                data.powers_mW.append(float(m.group(1)))
                continue
            m = _TEMP_RE.search(line)
            if m:
                data.temperatures_K.append(float(m.group(1)))
    return data


def parse_metrics_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
