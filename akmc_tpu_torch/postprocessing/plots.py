"""Plotting utilities — functional equivalents of the reference's
postprocessing scripts (plot_IV.py, plot_current.py, plot_conductance.py,
plot_power.py, plot_temperature.py, plot_temperature_current.py,
plot_kmc_timeline.py, plot_bond_current.py, show_device.py,
show_device_top.py); the counterpart of ``akmc_tpu/postprocessing/plots.py``,
figure for figure.

Host-side tools over the driver's output files. They need matplotlib (the
Agg backend, imported at the first plot), which the machine with the card
lacks: there they raise ``ImportError``.

CLI:  python -m akmc_tpu_torch.postprocessing.plots <kind> <output_txt|xyz> [out.png]
      kind in {iv, timeline, temperature, current, conductance, power,
               temperature_current, device, device_top}
"""

from __future__ import annotations

import sys

import numpy as np

from akmc_tpu_torch.lattice import ELEM, NAME_TO_ELEMENT, read_xyz
from akmc_tpu_torch.postprocessing.extract import parse_output_txt


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_iv(output_txt: str, out_png: str = "iv.png"):
    """I-V hysteresis (plot_IV.py equivalent): the LAST current logged
    within each bias point vs applied voltage — the reference scraper
    keeps current_track[-1] at every "Applied Voltage =" line
    (plot_IV.py:26-38), i.e. the end-of-bias current, so multi-superstep
    bias points contribute one point each."""
    plt = _mpl()
    # the reference scraper's exact state machine: at each new bias line,
    # record the last current seen so far; one final record at EOF
    vs, cs = [], []
    track = []
    with open(output_txt) as f:
        for line in f:
            if "Applied Voltage =" in line:
                vs.append(float(line.split()[3]))
                if track and len(cs) < len(vs) - 1:
                    cs.append(track[-1])
            elif "Current [uA]:" in line:
                track.append(float(line.split()[-1]))
    if track:
        cs.append(track[-1])
    n = min(len(vs), len(cs))
    fig, ax = plt.subplots(figsize=(5, 4))
    if n:
        ax.semilogy(vs[:n], [abs(c) for c in cs[:n]], "o-")
    ax.set_xlabel("Applied Voltage [V]")
    ax.set_ylabel("|I| [uA]")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_kmc_timeline(output_txt: str, out_png: str = "kmc_timeline.png"):
    plt = _mpl()
    d = parse_output_txt(output_txt)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.semilogy(np.arange(1, len(d.kmc_times) + 1), d.kmc_times, ".-")
    ax.set_xlabel("KMC superstep")
    ax.set_ylabel("KMC time [s]")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_temperature(output_txt: str, out_png: str = "temperature.png"):
    plt = _mpl()
    d = parse_output_txt(output_txt)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(d.temperatures_K, ".-")
    ax.set_xlabel("KMC superstep")
    ax.set_ylabel("Global temperature [K]")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def _plot_vs_time(times, values, ylabel, title, out_png):
    """Shared dual-axis (linear left / log right) timeline plot — the
    layout the reference uses for current, conductance and power
    (plot_current.py:38-58)."""
    plt = _mpl()
    n = min(len(times), len(values))
    times, values = times[:n], values[:n]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(times, values, marker="o", markersize=1, linestyle="-")
    ax2 = ax.twinx()
    ax2.plot(times, np.abs(values), marker="o", markersize=1, linestyle="-", color="red")
    if n and np.any(np.abs(values)):
        ax2.set_yscale("log")
    ax.set_xlabel("KMC Time")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_current(output_txt: str, out_png: str = "current.png"):
    """Current vs cumulative KMC time (plot_current.py equivalent):
    times accumulate across bias points with the reference's reset rule."""
    d = parse_output_txt(output_txt)
    return _plot_vs_time(
        [0.0] + d.cum_times, [0.0] + d.currents_uA,
        "|Current| (uA)", "Current vs KMC Time", out_png,
    )


def plot_conductance(output_txt: str, out_png: str = "conductance.png"):
    """Conductance vs cumulative KMC time (plot_conductance.py equivalent)."""
    d = parse_output_txt(output_txt)
    return _plot_vs_time(
        [0.0] + d.cum_times, [0.0] + d.conductances_uS,
        "Conductance (uS)", "Conductance vs KMC Time", out_png,
    )


def plot_power(output_txt: str, out_png: str = "power.png"):
    """Dissipated power vs cumulative KMC time (plot_power.py equivalent)."""
    d = parse_output_txt(output_txt)
    return _plot_vs_time(
        [0.0] + d.cum_times, [0.0] + d.powers_mW,
        "Power (mW)", "Dissipated power vs KMC Time", out_png,
    )


def plot_temperature_current(output_txt: str, out_png: str = "temperature_current.png"):
    """3-panel current / power / temperature vs time on log-x axes
    (plot_temperature_current.py equivalent; panels truncated to the
    common length like the reference's list-pop loop)."""
    plt = _mpl()
    d = parse_output_txt(output_txt)
    n = min(len(d.cum_times), len(d.currents_uA), len(d.powers_mW),
            len(d.temperatures_K)) or min(len(d.cum_times), len(d.temperatures_K))
    t = d.cum_times[:n]
    fig, axes = plt.subplots(3, 1, figsize=(6, 8), tight_layout=True)
    for ax, vals, label in (
        (axes[0], d.currents_uA[:n], "Current (uA)"),
        (axes[1], d.powers_mW[:n], "Power (mW)"),
        (axes[2], d.temperatures_K[:n], "Temperature (K)"),
    ):
        m = min(len(t), len(vals))
        ax.plot(t[:m], vals[:m], marker=".", markersize=4)
        if m and all(x > 0 for x in t[:m]):
            ax.set_xscale("log")
        ax.set_xlabel("Time (s)")
        ax.set_ylabel(label)
    v = d.voltages[-1] if d.voltages else float("nan")
    fig.suptitle(f"Applied Voltage = {v} V")
    fig.savefig(out_png, dpi=100)
    plt.close(fig)
    return out_png


def plot_bond_current(snapshot_xyz: str, x_matrix_txt: str, out_png: str = "bond_current.png"):
    """Per-atom outgoing-current magnitude over the structure
    (plot_bond_current.py equivalent; 3D scatter colored by
    ||log(-X_row)|| instead of the reference's plotly isosurface)."""
    plt = _mpl()
    e, x, y, z = read_xyz(snapshot_xyz)
    X = np.loadtxt(x_matrix_txt)
    with np.errstate(invalid="ignore", divide="ignore"):
        mag = np.linalg.norm(np.nan_to_num(np.log(np.maximum(-X, 1e-300))), axis=1)
    n = min(len(x), len(mag))
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(x[:n], y[:n], z[:n], c=mag[:n], s=4, cmap="viridis")
    fig.colorbar(sc, ax=ax, label="|log outgoing current|")
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def _read_snapshot_full(path: str):
    """Read a 6-column snapshot (element x y z potential power,
    Device.cpp:214-232 format)."""
    names, cols = [], []
    with open(path) as f:
        n = int(f.readline().split()[0])
        f.readline()
        for _ in range(n):
            parts = f.readline().split()
            names.append(parts[0])
            vals = [float(v) for v in parts[1:6]]
            vals += [0.0] * (5 - len(vals))  # bare xyz files: no field columns
            cols.append(vals)
    e = np.array([int(NAME_TO_ELEMENT[s]) for s in names], np.int32)
    a = np.asarray(cols)
    return e, a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4]


def plot_device_top(snapshot_xyz: str, out_png: str = "device_top.png"):
    """show_device_top.py equivalent: 3-panel figure — structure scatter
    colored by defect species (V=-1, Od=+1, else 0; show_device_top.py:46-56),
    potential vs x, dissipated power vs x, using the snapshot's own field
    columns."""
    plt = _mpl()
    e, x, y, z, pot, pow_ = _read_snapshot_full(snapshot_xyz)
    colors = np.zeros(len(e))
    colors[e == int(ELEM.VACANCY)] = -1.0
    colors[e == int(ELEM.OXYGEN_DEFECT)] = +1.0
    colors += 1.0
    fig = plt.figure(figsize=(5, 6), tight_layout=True)
    ax = fig.add_subplot(3, 1, 1)
    ax.scatter(x, y, c=colors, s=2, alpha=0.5, cmap="viridis_r")
    ax.get_xaxis().set_ticks([])
    ax = fig.add_subplot(3, 1, 2)
    ax.grid(True)
    ax.scatter(x, pot, c=y, s=2, alpha=0.5, cmap="coolwarm")
    if len(pot):
        ax.set_ylim(float(np.min(pot)) - 2, float(np.max(pot)) + 2)
    ax.set_xlabel("x position(s) (A)")
    ax.set_ylabel("Potential (V)")
    ax = fig.add_subplot(3, 1, 3)
    ax.grid(True)
    ax.scatter(x, pow_, c=y, s=2, alpha=0.5, cmap="coolwarm")
    ax.set_xlabel("x position(s) (A)")
    ax.set_ylabel("Dissipated Power (W)")
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def plot_device(snapshot_xyz: str, out_png: str = "device.png"):
    """Filament visualization (show_device.py equivalent): vacancy /
    oxygen-defect positions colored by species, side view."""
    plt = _mpl()
    e, x, y, z = read_xyz(snapshot_xyz)
    fig, ax = plt.subplots(figsize=(8, 4))
    groups = [
        (ELEM.VACANCY, "tab:red", "V", 8),
        (ELEM.OXYGEN_DEFECT, "tab:blue", "Od", 8),
        (ELEM.Ti, "0.8", "Ti", 1),
        (ELEM.N, "0.9", "N", 1),
    ]
    for el, color, label, size in groups:
        m = e == int(el)
        if m.any():
            ax.scatter(x[m], y[m], s=size, c=color, label=label, linewidths=0)
    ax.set_xlabel("x [A]")
    ax.set_ylabel("y [A]")
    ax.legend(markerscale=2, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def main():
    if len(sys.argv) < 3:
        print(__doc__)
        sys.exit(1)
    kind, src = sys.argv[1], sys.argv[2]
    out = sys.argv[3] if len(sys.argv) > 3 else f"{kind}.png"
    fn = {
        "iv": plot_iv,
        "timeline": plot_kmc_timeline,
        "temperature": plot_temperature,
        "current": plot_current,
        "conductance": plot_conductance,
        "power": plot_power,
        "temperature_current": plot_temperature_current,
        "device": plot_device,
        "device_top": plot_device_top,
    }[kind]
    print(fn(src, out))


if __name__ == "__main__":
    main()
