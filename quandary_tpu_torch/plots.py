"""Visualization of pulses, populations, and energies, plus the Richardson
time-step estimator: the port's copy of quandary_tpu/plots.py.

The public names (plot_pulse, plot_expectedEnergy, plot_population,
plot_results_1osc, timestep_richardson_est) are the compatibility surface of
the reference front end (quandary.py:1202-1409). Every plot function builds
its figure through the object-oriented matplotlib API and RETURNS it
(callers decide whether to show, save, or embed); they run headless under
matplotlib's Agg backend. timestep_richardson_est drives the port's
Quandary (quandary_tpu_torch.api), in-process.
"""

from __future__ import annotations

import numpy as np


def _basis_label(iplot: int, n_osc: int) -> str:
    """Ket label for the iplot-th basis initial condition."""
    if n_osc == 1:
        return f"|{iplot}>"
    return "|" + format(iplot, f"0{n_osc}b") + ">"


def _init_grid(n_panels: int):
    """A (fig, flat axes list) grid sized for n_panels initial conditions:
    two columns once there are >= 4 panels, scaled so panels stay legible."""
    import matplotlib.pyplot as plt

    ncols = 2 if n_panels >= 4 else 1
    nrows = -(-n_panels // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, squeeze=False,
        figsize=(4.8 * ncols, 3.6 * nrows))
    flat = [ax for row in axes for ax in row]
    for ax in flat[n_panels:]:
        ax.set_visible(False)
    fig.subplots_adjust(hspace=0.5, wspace=0.5)
    return fig, flat[:n_panels]


def _finish(fig):
    import matplotlib.pyplot as plt

    plt.draw()
    plt.show()
    return fig


def plot_pulse(Ne, time, pt, qt):
    """One row per oscillator: the rotating-frame quadratures p(t), q(t) in
    MHz over the pulse duration, annotated with the peak amplitudes."""
    import matplotlib.pyplot as plt

    n_osc = len(Ne)
    fig, axes = plt.subplots(n_osc, 1, squeeze=False)
    fig.subplots_adjust(hspace=0.6)
    for k in range(n_osc):
        ax = axes[k][0]
        p = np.asarray(pt[k])
        q = np.asarray(qt[k])
        ax.plot(time, p, color="r", label="p(t)")
        ax.plot(time, q, color="b", label="q(t)")
        ax.set(xlabel="time (ns)", ylabel="Drive strength [MHz]",
               xlim=(0.0, time[-1]))
        ax.set_title(f"Qubit {k}\n max. drive "
                     f"{np.abs(p).max():.1f}, {np.abs(q).max():.1f} MHz")
        ax.legend(loc="lower right")
    return _finish(fig)


def plot_expectedEnergy(Ne, time, expectedEnergy):
    """Expected energy <n> per oscillator, one panel per initial basis
    state."""
    n_osc = len(Ne)
    ninit = len(expectedEnergy[0])
    fig, panels = _init_grid(ninit)
    for iplot, ax in enumerate(panels):
        top = 1.0
        for k in range(n_osc):
            trace = np.asarray(expectedEnergy[k][iplot])
            ax.plot(time, trace, label=f"Qubit {k}" if n_osc > 1 else "")
            top = max(top, trace.max())
        ax.set(xlabel="time (ns)", ylabel="expected energy",
               xlim=(0.0, time[-1]), ylim=(-1e-2, top + 1e-2))
        ax.set_title("from " + _basis_label(iplot, n_osc))
        ax.legend(loc="lower right")
    return _finish(fig)


def plot_population(Ne, time, population):
    """Level populations per oscillator, one panel per initial basis
    state."""
    n_osc = len(Ne)
    ninit = len(population[0])
    fig, panels = _init_grid(ninit)
    for iplot, ax in enumerate(panels):
        for k in range(n_osc):
            prefix = f"Qubit {k} " if n_osc > 1 else ""
            for lvl in range(Ne[k]):
                ax.plot(time, population[k][iplot][lvl],
                        label=prefix + f"|{lvl}>")
        ax.set(xlabel="time (ns)", ylabel="population",
               xlim=(0.0, time[-1]), ylim=(-1e-4, 1.0 + 1e-2))
        ax.set_title("from " + _basis_label(iplot, n_osc))
        ax.legend(loc="lower right")
    return _finish(fig)


def plot_results_1osc(myconfig, p, q, expectedEnergy, population):
    """Single-oscillator dashboard: pulse quadratures, pulse power spectrum,
    expected energy, and per-initial-condition populations."""
    import matplotlib.pyplot as plt

    t = myconfig.time
    fig, ax = plt.subplots(2, 3, figsize=(20, 8))
    fig.subplots_adjust(hspace=0.3)

    # (0,0) pulse quadratures
    ax[0, 0].plot(t, p, label="I")
    ax[0, 0].plot(t, q, label="Q")
    ax[0, 0].set(xlabel="Time (ns)", ylabel="Pulse amplitude (MHz)")
    ax[0, 0].legend()
    ax[0, 0].grid()

    # (0,1) power spectrum of the complex envelope (GHz units internally,
    # displayed in MHz)
    env = (np.asarray(p) + 1j * np.asarray(q)) * 1e-3
    power = np.abs(np.fft.fft(env)) ** 2
    freqs = np.fft.fftfreq(env.size, d=myconfig.T / myconfig.nsteps)
    ax[0, 1].scatter(freqs * 1e3, power)
    ax[0, 1].set(xlabel="Frequency (MHz)", ylabel="FFT", title="FFT",
                 yscale="log", xlim=(-500, 500))
    ax[0, 1].grid()

    # (0,2) expected energy per initial condition
    for iinit, trace in enumerate(expectedEnergy):
        ax[0, 2].plot(t, trace, label=f"from |{iinit}>")
    ax[0, 2].set(xlabel="Time (ns)", ylabel="Expected Energy Level",
                 title="Expected Energy Level")
    ax[0, 2].legend()
    ax[0, 2].grid()

    # bottom row: populations, one panel per initial condition (the grid
    # has 3 bottom panels; additional initial conditions wrap into hidden
    # axes rather than indexing out of bounds)
    for iinit, pops in enumerate(population[:3]):
        for lvl in range(myconfig.Ne[0]):
            ax[1, iinit].plot(t, pops[lvl], label=f"|{lvl}>")
        ax[1, iinit].set(xlabel="Time (ns)", ylabel="Population",
                         title=f"Populations from |{iinit}>")
        ax[1, iinit].legend()
        ax[1, iinit].grid()
    return _finish(fig)


def timestep_richardson_est(quandary, tol=1e-8, order=2, quandary_exec="",
                            datadir="TS_test", max_refinements=10, **kwargs):
    """Richardson error estimate for the time discretization: repeatedly
    double nsteps and estimate the order-`order` error of the infidelity and
    of the final unitary as |coarse - fine| / (2^order - 1); stop when the
    infidelity error drops below `tol`.

    Returns (errs_J, errs_u, dts): per-refinement error estimates and the
    coarse step sizes they correspond to. `quandary_exec` is accepted for
    reference-signature compatibility and ignored (execution is in-process).
    """
    refine = 2
    amplification = refine ** order - 1.0

    quandary.verbose = False
    _, _, _, J_coarse, _, _ = quandary.simulate(datadir=datadir)
    u_coarse = np.array(quandary.uT)

    errs_J, errs_u, dts = [], [], []
    for _ in range(max_refinements):
        dt_coarse = quandary.T / quandary.nsteps
        quandary.nsteps *= refine
        quandary.dT = quandary.T / quandary.nsteps
        _, _, _, J_fine, _, _ = quandary.simulate(datadir=datadir)

        err_J = abs(J_coarse - J_fine) / amplification
        err_u = np.linalg.norm(u_coarse - np.array(quandary.uT)) / amplification
        errs_J.append(err_J)
        errs_u.append(err_u)
        dts.append(dt_coarse)
        print(f" -> Error at i={len(dts) - 1}, dt = {dt_coarse}: "
              f"err_J = {err_J} err_u= {err_u}")
        if err_J < tol:
            print(f"\n -> Tolerance reached. N={quandary.nsteps}, "
                  f"dt={dt_coarse}")
            break
        J_coarse = J_fine
        u_coarse = np.array(quandary.uT)
    return errs_J, errs_u, dts
