"""Seeded LAMMPS dumps and flux files for the port's transport and
conductivity paths, float64 direct sums of their series, and the comparison
of two transport results.

Numpy only, so that ``chip_smoke.py`` imports it as the tests do.

``random_walk`` makes a wrapped random walk whose per-frame step is exactly
the written velocity times the frame interval; ``write_dump`` writes any
per-atom columns as a ``dump custom`` text file with numpy alone, atom rows
shuffled per frame when asked. ``msd_sums_direct`` and ``acf_sums_direct``
are plain float64 sums of the windowed MSD and the windowed biased ACF,
lag by lag. The checks hold results to the port's transport tolerance:
every Einstein output within rtol 1e-5; the GK ACF within rtol 1e-5 plus an
atol of 1e-5 x acf[0] (float32 FFT rounding is relative to the largest
term), its integrals, D and SEM within rtol 1e-5 plus an atol of 1e-5 x
acf[0] x the longest lag time.

``flux_columns`` adds seeded forces, per-atom energies and stresses to a
walk; ``flux_series_direct`` evaluates the six flux transformations'
formulas in float64 on stored arrays; ``gk_system_direct`` and
``msd_system_direct`` are the system calculators' window averages of one
``(T, 1, 3)`` series, and ``assert_system_close`` holds two system results
to the transport tolerance; ``write_flux_file`` writes a LAMMPS flux (log)
file.

``distinct_series_direct`` gives the distinct diffusion pair's window-mean
MSD and VACF series in float64 from stored arrays, through the bilinear form
(a correlation of particle-mean series less the atom-mean self term, O(N)
per window); ``assert_distinct_close`` holds two distinct results to the
distinct tolerance and ``assert_counts_close`` two histograms of counts to
the SDF's.
"""

import numpy as np

#: the reference's species names, in the order of ``counts``
SPECIES = ("Na", "Cl", "K", "F")


def random_walk(counts, n_frames, box, sigma, dt_frame, seed):
    """``(wrapped, unwrapped, velocities, names)`` of a random walk.

    Velocities are drawn with sd ``sigma / dt_frame`` per axis and rounded to
    the 6 decimals a dump keeps; ``unwrapped[t + 1] = unwrapped[t] + v[t] *
    dt_frame`` from uniform starts in the box, so ``CoordinateUnwrapper``
    recovers ``unwrapped`` and D is ``sigma**2 / (2 dt_frame)``.
    """
    rng = np.random.default_rng(seed)
    n = sum(counts)
    vel = np.round(rng.normal(scale=sigma / dt_frame, size=(n_frames, n, 3)), 6)
    unwrapped = np.empty((n_frames, n, 3))
    unwrapped[0] = rng.uniform(0.0, box, (n, 3))
    np.cumsum(vel[:-1] * dt_frame, axis=0, out=unwrapped[1:])
    unwrapped[1:] += unwrapped[0]
    names = np.repeat(np.array(SPECIES[: len(counts)]), counts)
    return np.mod(unwrapped, box), unwrapped, vel, names


def walk_columns(wrapped, vel, names, with_id=True, label="element"):
    """The ``id element x y z vx vy vz`` columns of a walk (``type`` ids
    1, 2, ... with ``label="type"``)."""
    n = wrapped.shape[1]
    cols = {}
    if with_id:
        cols["id"] = np.arange(1, n + 1)
    if label == "type":
        cols["type"] = np.unique(names, return_inverse=True)[1] + 1
    else:
        cols["element"] = names
    for i, axis in enumerate("xyz"):
        cols[axis] = wrapped[:, :, i]
    for i, axis in enumerate("xyz"):
        cols[f"v{axis}"] = vel[:, :, i]
    return cols


def _digits(m, n):
    """ASCII digits (..., n) uint8 of non-negative int64 ``m``, zero-padded."""
    powers = 10 ** np.arange(n - 1, -1, -1, dtype=np.int64)
    return (m[..., None] // powers % 10 + 48).astype(np.uint8)


def _fixed6(v):
    """Text (..., width) uint8 of floats ``v`` with 6 decimals: a sign (space
    or minus), zero-padded integer digits, the point, the decimals."""
    m = np.rint(np.abs(v) * 1e6).astype(np.int64)
    int_digits = len(str(int(m.max(initial=0)) // 10**6))
    sign = np.where(v < 0, ord("-"), ord(" ")).astype(np.uint8)[..., None]
    point = np.full(v.shape + (1,), ord("."), np.uint8)
    return np.concatenate(
        [sign, _digits(m // 10**6, int_digits), point, _digits(m % 10**6, 6)], -1
    )


def _text(values):
    """Text (..., width) uint8 of integers or strings, right-justified."""
    strings = np.asarray(values).astype(str)
    width = int(np.char.str_len(strings).max(initial=1))
    padded = np.char.rjust(strings, width).astype(f"S{width}")
    return np.frombuffer(padded.tobytes(), np.uint8).reshape(strings.shape + (width,))


def write_dump(path, box, columns, every=1, shuffle_seed=None, first_step=0,
               frames_per_block=50):
    """Write ``columns`` (name -> (T, N) per-frame array, or (N,) per-atom
    values repeated every frame) as a LAMMPS ``dump custom`` file.

    Floats are written with 6 decimals, integers as integers. Each block of
    frames is formatted as one uint8 array of fixed-width rows. With
    ``shuffle_seed`` the atom rows of each frame come in a seeded order.
    """
    n_frames, n_atoms = next(v.shape[:2] for v in columns.values() if np.ndim(v) == 2)
    rng = np.random.default_rng(shuffle_seed)
    per_atom = {k: _text(v) for k, v in columns.items()
                if np.ndim(v) == 1 and np.asarray(v).dtype.kind != "f"}
    header = (
        "ITEM: TIMESTEP\n{}\nITEM: NUMBER OF ATOMS\n" + f"{n_atoms}\n"
        + "ITEM: BOX BOUNDS pp pp pp\n" + f"0.0 {box}\n" * 3
        + "ITEM: ATOMS " + " ".join(columns) + "\n"
    )
    with open(path, "wb") as f:
        for f0 in range(0, n_frames, frames_per_block):
            f1 = min(f0 + frames_per_block, n_frames)
            shape = (f1 - f0, n_atoms)
            space = np.full(shape + (1,), ord(" "), np.uint8)
            cols = []
            for name, values in columns.items():
                v = np.asarray(values)
                if name in per_atom:
                    text = per_atom[name]
                else:
                    v = v[f0:f1] if v.ndim == 2 else v
                    text = _fixed6(v) if v.dtype.kind == "f" else _text(v)
                cols += [space] if cols else []
                cols.append(np.broadcast_to(text, shape + text.shape[-1:]))
            cols.append(np.full(shape + (1,), ord("\n"), np.uint8))
            rows = np.concatenate(cols, -1)
            for i in range(f1 - f0):
                order = rng.permutation(n_atoms) if shuffle_seed is not None else slice(None)
                f.write(header.format(first_step + (f0 + i) * every).encode())
                f.write(rows[i, order].tobytes())


def msd_sums_direct(x, window, stride):
    """``(window,)`` float64 sums over windows, atoms and axes of
    ``(x[w + m] - x[w])**2``, one lag at a time from float64 copies of ``x``
    (T, N, 3); windows start every ``stride`` frames and fit whole."""
    x = np.asarray(x, np.float64)
    n_windows = (len(x) - window) // stride + 1
    origins = x[: (n_windows - 1) * stride + 1 : stride]
    return np.array([
        np.square(x[m : m + (n_windows - 1) * stride + 1 : stride] - origins).sum()
        for m in range(window)
    ])


def acf_sums_direct(v, window, stride):
    """``(window,)`` float64 sums over windows, atoms and axes of each
    window's biased ACF ``(1/window) sum_t v[w + t] v[w + t + m]``.

    Lag ``m`` sums diagonal ``m`` of the frames' float64 Gram matrix, each
    product of frames ``t`` and ``t + m`` weighted by the number of windows
    that hold both."""
    v = np.asarray(v, np.float64).reshape(len(v), -1)
    total = len(v)
    n_windows = (total - window) // stride + 1
    # short series: one Gram matrix; long ones (a flux log): lag by lag
    gram = v @ v.T if total <= 4096 else None
    out = np.empty(window)
    for m in range(window):
        t = np.arange(total - m)
        first = np.maximum(0, -(-(t + m - window + 1) // stride))
        last = np.minimum(n_windows - 1, t // stride)
        products = np.diagonal(gram, m) if gram is not None else np.einsum("ti,ti->t", v[: total - m], v[m:])
        out[m] = np.dot(products, np.maximum(last - first + 1, 0)) / window
    return out


def assert_series_match_direct(einstein, gk, unwrapped, velocities, window, stride,
                               length, time):
    """Hold one species' Einstein MSD and GK ACF series (tau = every lag) to
    the direct float64 sums of its stored arrays, divided by the reference's
    ``n_windows * (n_atoms + 1)`` and converted with the experiment's
    ``length`` and ``time`` units: MSD within rtol 1e-5, ACF within rtol 1e-5
    plus 1e-5 x acf[0]. Returns the largest errors: ``msd`` relative,
    ``acf`` over acf[0]."""
    n_windows = (len(unwrapped) - window) // stride + 1
    count = n_windows * (unwrapped.shape[1] + 1)
    msd = msd_sums_direct(unwrapped, window, stride) / count * length**2
    np.testing.assert_allclose(einstein["msd"], msd, rtol=1e-5, err_msg="msd")
    acf = acf_sums_direct(velocities, window, stride) / count * length**2 / time**2
    np.testing.assert_allclose(gk["acf"], acf, rtol=1e-5, atol=1e-5 * abs(acf[0]), err_msg="acf")
    msd_err = np.abs(np.asarray(einstein["msd"]) - msd)
    return {
        "msd": float(np.max(msd_err[msd != 0] / np.abs(msd[msd != 0]), initial=0.0)),
        "acf": float(np.max(np.abs(np.asarray(gk["acf"]) - acf)) / abs(acf[0])),
    }


def assert_einstein_close(ours, ref):
    for sp in ref:
        assert set(ours[sp]) == set(ref[sp])
        for key, value in ref[sp].items():
            np.testing.assert_allclose(ours[sp][key], value, rtol=1e-5, err_msg=f"{sp} {key}")


def assert_gk_close(ours, ref):
    for sp in ref:
        acf0 = abs(ref[sp]["acf"][0])
        t = np.asarray(ref[sp]["time"])
        np.testing.assert_allclose(ours[sp]["time"], t, rtol=1e-12)
        np.testing.assert_allclose(ours[sp]["acf"], ref[sp]["acf"], rtol=1e-5, atol=1e-5 * acf0)
        for key in ("integral", "integral_uncertainty", "diffusion_coefficient", "uncertainty"):
            np.testing.assert_allclose(
                ours[sp][key], ref[sp][key], rtol=1e-5, atol=1e-5 * acf0 * t[-1], err_msg=key
            )


#: the six flux transformations' output properties
FLUX_SERIES = ("Ionic_Current", "Translational_Dipole_Moment", "Thermal_Flux",
               "Integrated_Heat_Current", "Kinaci_Heat_Current", "Momentum_Flux")

#: Voigt index of the symmetric stress tensor's (a, b) component
VOIGT = np.array([[0, 3, 4], [3, 1, 5], [4, 5, 2]])


def flux_columns(n_frames, n_atoms, seed):
    """Seeded ``fx fy fz c_KE c_PE c_Stress[1..6]`` columns, (T, N) each,
    rounded to the 6 decimals a dump keeps: forces of sd 1 eV/A, kinetic
    energies in [0, 0.2) eV, potential energies in [-6, -2) eV, stresses of
    sd 1000 bar A^3."""
    rng = np.random.default_rng(seed)
    shape = (n_frames, n_atoms)
    cols = {f"f{a}": rng.normal(size=shape) for a in "xyz"}
    cols["c_KE"] = rng.uniform(0.0, 0.2, shape)
    cols["c_PE"] = rng.uniform(-6.0, -2.0, shape)
    for i in range(6):
        cols[f"c_Stress[{i + 1}]"] = rng.normal(scale=1000.0, size=shape)
    return {k: np.round(v, 6) for k, v in cols.items()}


def flux_series_direct(data, charges, dt):
    """The six flux series ``{name: (T, 3)}`` in float64 from per-species
    arrays ``data[species][property]`` of shape (T, N, d) (``Velocities``,
    ``Unwrapped_Positions``, ``Forces``, ``Stress``, ``Kinetic_Energy``,
    ``Potential_Energy``), species charges ``{species: q}`` and the frame
    interval ``dt``; Kinaci with each species' integral kept apart."""
    out = {name: 0.0 for name in FLUX_SERIES}
    for sp, d in data.items():
        v, r, f, s = (np.asarray(d[k], np.float64) for k in
                      ("Velocities", "Unwrapped_Positions", "Forces", "Stress"))
        ke, pe = (np.asarray(d[k], np.float64)[..., 0] for k in ("Kinetic_Energy", "Potential_Energy"))
        q = charges[sp]
        integral = np.cumsum(np.einsum("tnd,tnd->tn", f, v), axis=0) * dt
        out["Ionic_Current"] = out["Ionic_Current"] + q * v.sum(1)
        out["Translational_Dipole_Moment"] = out["Translational_Dipole_Moment"] + q * r.sum(1)
        out["Thermal_Flux"] = out["Thermal_Flux"] + np.einsum("tn,tnd->td", ke + pe, v) \
            - np.einsum("tnab,tnb->ta", s[..., VOIGT], v)
        out["Integrated_Heat_Current"] = out["Integrated_Heat_Current"] \
            + np.einsum("tn,tnd->td", ke + pe, r)
        out["Kinaci_Heat_Current"] = out["Kinaci_Heat_Current"] \
            + np.einsum("tn,tnd->td", integral + pe, r)
        out["Momentum_Flux"] = out["Momentum_Flux"] + s[..., 3:6].sum(1)
    return out


def gk_system_direct(series, window, stride, times, acf_scale=1.0):
    """``(acf, integral)`` of a system series (T, 1, 3) as the GK system
    calculators average it: the windowed biased ACF summed over axes, over
    the window count, times ``acf_scale``; its cumulative trapezoid over
    ``times``."""
    n_windows = (len(series) - window) // stride + 1
    acf = acf_sums_direct(series, window, stride) / n_windows * acf_scale
    integral = np.cumsum((acf[1:] + acf[:-1]) / 2 * np.diff(times))
    return acf, integral


def msd_system_direct(series, window, stride):
    """The windowed MSD of a system series (T, 1, 3) over the window count,
    as the Einstein-Helfand calculators average it (before the prefactor)."""
    n_windows = (len(series) - window) // stride + 1
    return msd_sums_direct(series, window, stride) / n_windows


def assert_system_close(ours, ref):
    """Hold one system result (``data_dict["System"]``) to another at the
    transport tolerance: Einstein-Helfand outputs within rtol 1e-5;
    Green-Kubo ACF within rtol 1e-5 plus 1e-5 x acf[0], integrals within
    rtol 1e-5 plus 1e-5 x acf[0] x the longest lag time, the coefficient
    and its uncertainty the same times the prefactor (the reference
    estimator's per-window integrals carry the prefactor already)."""
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    if "acf" not in ref:
        for key, value in ref.items():
            np.testing.assert_allclose(ours[key], value, rtol=1e-5, err_msg=key)
        return
    acf0, t = abs(ref["acf"][0]), np.asarray(ref["time"])
    np.testing.assert_allclose(ours["time"], t, rtol=1e-12)
    np.testing.assert_allclose(ours["acf"], ref["acf"], rtol=1e-5, atol=1e-5 * acf0, err_msg="acf")
    series = ("time", "acf", "integral", "integral_uncertainty")
    values = [k for k in ref if k not in series]
    if not ref["integral_uncertainty"]:  # reference estimator: per-window integrals
        scale = 1e-5 * np.abs(ref["integral"]).max()
        for key in ["integral"] + values:
            np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, atol=scale, err_msg=key)
        return
    scale = 1e-5 * acf0 * t[-1]
    for key in ("integral", "integral_uncertainty"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, atol=scale, err_msg=key)
    value = next(k for k in values if k != "uncertainty")
    prefactor = abs(ref[value][0] / ref["integral"][-1]) if ref["integral"][-1] else 1.0
    for key in values:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5, atol=scale * prefactor, err_msg=key)


def write_flux_file(path, columns, rows_per_block=100_000):
    """Write ``columns`` (name -> (T,) array) as a LAMMPS flux file: a
    comment line, the column names, one row a step; floats with 6
    decimals, integers as integers."""
    n_rows = len(next(iter(columns.values())))
    with open(path, "wb") as f:
        f.write(b"# flux log\n" + " ".join(columns).encode() + b"\n")
        for r0 in range(0, n_rows, rows_per_block):
            r1 = min(r0 + rows_per_block, n_rows)
            cols = []
            for values in columns.values():
                v = np.asarray(values)[r0:r1]
                cols += [np.full((r1 - r0, 1), ord(" "), np.uint8)] if cols else []
                cols.append(_fixed6(v) if v.dtype.kind == "f" else _text(v))
            cols.append(np.full((r1 - r0, 1), ord("\n"), np.uint8))
            f.write(np.concatenate(cols, -1).tobytes())


def cross_sums_direct(a, b, window, stride):
    """``(window,)`` float64 sums over windows and axes of each window's raw
    cross-correlation ``sum_t b[w + t] . a[w + t + m]`` of two (T, 3) series,
    from their float64 Gram matrix (products weighted by the number of
    windows that hold both frames)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    total = len(a)
    n_windows = (total - window) // stride + 1
    gram = b @ a.T  # gram[t, u] = b[t] . a[u]
    out = np.empty(window)
    for m in range(window):
        t = np.arange(total - m)
        first = np.maximum(0, -(-(t + m - window + 1) // stride))
        last = np.minimum(n_windows - 1, t // stride)
        out[m] = np.dot(np.diagonal(gram, m), np.maximum(last - first + 1, 0))
    return out


def distinct_series_direct(a, b, window, stride, same, kind, length, time=1.0, frame=1.0):
    """The distinct pair's series for every lag in float64, from stored
    (T, N, 3) arrays ``a`` and ``b``: ``kind="msd"`` the Einstein pair's
    (positions), ``"vacf"`` the Green-Kubo pair's (velocities, and then also
    its D as the second value, for the ``time`` unit and the raw ``frame``
    interval: the window mean of per-window trapezoids is the trapezoid of
    the window mean).

    Per window, the cross term of the particle-mean series averaged over the
    axes, less the atom-mean self term when ``same``; averaged over windows;
    the MSD in ``length**2``, the VACF in raw units.
    """
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    n_windows = (len(a) - window) // stride + 1
    ma, mb = a.mean(axis=1), b.mean(axis=1)
    if kind == "msd":
        origins = slice(0, (n_windows - 1) * stride + 1, stride)
        cross = np.array([
            np.sum((ma[m:][origins] - ma[origins]) * (mb[m:][origins] - mb[origins]))
            for m in range(window)
        ]) / 3
        self_sum = msd_sums_direct(a, window, stride) / 3 if same else 0.0
        return (cross - self_sum / a.shape[1]) / n_windows * length**2
    cross = cross_sums_direct(ma, mb, window, stride) / 3
    self_sum = acf_sums_direct(a, window, stride) * window / 3 if same else 0.0
    vacf = (cross - self_sum / a.shape[1]) / n_windows
    times = np.arange(window) * frame
    return vacf, length**2 / (time * (window - 1)) * np.trapezoid(vacf, x=times)


def assert_distinct_close(ours, ref, key):
    """Two results of one distinct class: every series within rtol 1e-5 plus
    1e-6 x the largest same-species value of that series, D the same (atol
    1e-6 x the largest same-species |D|), the uncertainty within rtol 1e-3."""
    assert list(ours) == list(ref)
    same = [p for p in ref if p.split("_")[0] == p.split("_")[1]]
    scale = max(np.abs(ref[p][key]).max() for p in same)
    d_scale = max(abs(np.ravel(ref[p]["diffusion_coefficient"])[0]) for p in same)
    for pair, values in ref.items():
        np.testing.assert_allclose(ours[pair]["time"], values["time"], rtol=1e-12)
        np.testing.assert_allclose(ours[pair][key], values[key], rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=f"{pair} {key}")
        np.testing.assert_allclose(ours[pair]["diffusion_coefficient"], values["diffusion_coefficient"],
                                   rtol=1e-5, atol=1e-6 * d_scale, err_msg=f"{pair} D")
        np.testing.assert_allclose(ours[pair]["uncertainty"], values["uncertainty"], rtol=1e-3,
                                   err_msg=f"{pair} uncertainty")


def assert_counts_close(ours, ref):
    """Two histograms of counts: totals within 0.01 % and the summed per-bin
    difference within max(4, 1e-4 x the total). Returns ``(total difference,
    summed per-bin difference)``."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    total = ref.sum()
    assert total > 0
    diff_total, diff_bins = abs(ours.sum() - total), np.abs(ours - ref).sum()
    assert diff_total <= 1e-4 * total, (diff_total, total)
    assert diff_bins <= max(4.0, 1e-4 * total), (diff_bins, total)
    return float(diff_total), float(diff_bins)
