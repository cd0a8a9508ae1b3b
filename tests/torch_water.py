"""Seeded rigid-water trajectories and GROMACS / DCD / extxyz writers for the
port's molecular path.

Numpy only (it imports no package of the repo), so that ``chip_smoke.py``
imports it as the tests do.

``water_box`` places ``n_side``^3 rigid waters of SPC/E geometry (O-H 1.0 A,
H-O-H 109.47 deg) on a cubic grid, in GROMACS atom order (OW, HW1, HW2 per
molecule), with random orientations redrawn until no two molecules have
atoms within ``clearance`` at the first frame. Each molecule's centre of
mass walks with sd ``sigma`` per axis a frame and the molecule turns by a
small random rotation each frame, so its atoms do not merely translate. The
positions are wrapped per atom, as ``mdrun`` writes them: with
``straddle=True`` the grid sits 0.2-0.4 A from the lower box faces, so the
molecules of those layers straddle a face at the first frame.

The writers follow the published formats: ``.gro`` (GROMACS manual, fixed
columns, nm), TRR (GROMACS ``xdrfile_trr.c``, XDR big-endian, nm), DCD
(CHARMM unformatted records with a unit cell, Angstrom) and extended XYZ
(``Lattice=`` and ``Properties=species:S:1:pos:R:3``).
"""

import struct

import numpy as np

#: GROMACS atom names of one water and their elements
ATOM_NAMES = ("OW", "HW1", "HW2")
ELEMENTS = ("O", "H", "H")
#: the masses of the port's element table (``data/elements.py``)
MASSES = {"O": 15.999, "H": 1.008}
BOND = 1.0  # A, SPC/E
ANGLE = np.deg2rad(109.47)


def body_coordinates():
    """``(3, 3)`` positions of O, H1, H2 relative to the molecule's COM."""
    half = ANGLE / 2
    atoms = np.array([
        [0.0, 0.0, 0.0],
        [np.sin(half), np.cos(half), 0.0],
        [-np.sin(half), np.cos(half), 0.0],
    ]) * BOND
    m = np.array([MASSES[e] for e in ELEMENTS])
    return atoms - (m[:, None] * atoms).sum(0) / m.sum()


def _rotations(vectors):
    """Rotation matrices ``(..., 3, 3)`` of axis-angle ``vectors`` (Rodrigues)."""
    theta = np.linalg.norm(vectors, axis=-1)[..., None, None]
    k = vectors / np.maximum(np.linalg.norm(vectors, axis=-1, keepdims=True), 1e-300)
    cross = np.zeros(vectors.shape[:-1] + (3, 3))
    cross[..., 0, 1], cross[..., 0, 2] = -k[..., 2], k[..., 1]
    cross[..., 1, 0], cross[..., 1, 2] = k[..., 2], -k[..., 0]
    cross[..., 2, 0], cross[..., 2, 1] = -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(theta) * cross + (1 - np.cos(theta)) * cross @ cross


def _random_orientations(rng, n):
    """``n`` uniformly random rotation matrices (from unit quaternions)."""
    q = rng.normal(size=(n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def water_box(n_side, n_frames, box, sigma, seed, rotation_sd=0.05,
              clearance=2.0, straddle=True):
    """A rigid-water walk; returns a dict of float64 arrays in Angstrom.

    ``unwrapped`` and ``wrapped`` are ``(n_frames, 3 n_mol, 3)`` in GROMACS
    order, ``com`` the ``(n_frames, n_mol, 3)`` true centres of mass
    (unwrapped), ``velocities`` the forward differences of ``unwrapped``
    over one frame (the last frame repeats), ``straddling`` the number of
    molecules whose atoms lie in more than one image at the first frame.
    """
    rng = np.random.default_rng(seed)
    n_mol = n_side ** 3
    spacing = box / n_side
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    offset = rng.uniform(0.2, 0.4, 3) if straddle else np.full(3, spacing / 2)
    com0 = grid * spacing + offset
    body = body_coordinates()
    rot = _random_orientations(rng, n_mol)
    # redraw one molecule of every pair of grid neighbours that comes closer
    # than the clearance until none does
    shifts = [s for s in np.ndindex(3, 3, 3) if s > (1, 1, 1)]
    flat = lambda g: (g[:, 0] * n_side + g[:, 1]) * n_side + g[:, 2]  # noqa: E731
    for _ in range(1000):
        atoms = com0[:, None] + np.einsum("mij,aj->mai", rot, body)
        clash = np.zeros(n_mol, bool)
        for s in shifts:
            other = flat((grid + np.array(s) - 1) % n_side)
            d = atoms[:, :, None] - atoms[other][:, None, :]
            d -= box * np.round(d / box)
            clash |= (np.einsum("mabi,mabi->mab", d, d) < clearance ** 2).any(axis=(1, 2))
        if not clash.any():
            break
        rot[clash] = _random_orientations(rng, int(clash.sum()))
    else:
        raise RuntimeError("water_box: could not clear the first frame")
    steps = rng.normal(scale=sigma, size=(n_frames, n_mol, 3))
    steps[0] = 0.0
    com = com0 + np.cumsum(steps, axis=0)
    unwrapped = np.empty((n_frames, n_mol, 3, 3))
    for t in range(n_frames):
        if t:
            rot = _rotations(rng.normal(scale=rotation_sd, size=(n_mol, 3))) @ rot
        unwrapped[t] = com[t][:, None] + np.einsum("mij,aj->mai", rot, body)
    unwrapped = unwrapped.reshape(n_frames, 3 * n_mol, 3)
    wrapped = unwrapped - box * np.floor(unwrapped / box)
    velocities = np.empty_like(unwrapped)
    velocities[:-1] = np.diff(unwrapped, axis=0)
    velocities[-1] = velocities[-2] if n_frames > 1 else 0.0
    images = np.floor(unwrapped[0] / box).reshape(n_mol, 3, 3)
    straddling = int((images != images[:, :1]).any(axis=(1, 2)).sum())
    return dict(unwrapped=unwrapped, wrapped=wrapped, com=com,
                velocities=velocities, straddling=straddling, n_mol=n_mol)


def species_rows(n_mol):
    """``{element: [atom rows]}`` of ``n_mol`` waters in GROMACS order."""
    rows = np.arange(3 * n_mol).reshape(n_mol, 3)
    return {"O": rows[:, 0].tolist(), "H": rows[:, 1:].ravel().tolist()}


# ------------------------------------------------------------------ writers
def write_gro(path, positions, box, velocities=None, dt_frame=0.02):
    """A multi-frame ``.gro`` of waters: Angstrom in, nm written, 3 decimals
    for positions and 4 for velocities (A/ps in, nm/ps written); the title
    carries ``t=`` in ps."""
    n_frames, n_atoms, _ = positions.shape
    prefixes = [
        "%5d%-5s%5s%5d" % ((a // 3 + 1) % 100000, "SOL", ATOM_NAMES[a % 3], (a + 1) % 100000)
        for a in range(n_atoms)
    ]
    fmt = "%8.3f%8.3f%8.3f" + ("%8.4f%8.4f%8.4f" if velocities is not None else "") + "\n"
    with open(path, "w") as f:
        for t in range(n_frames):
            rows = positions[t] / 10.0
            if velocities is not None:
                rows = np.concatenate([rows, velocities[t] / 10.0], axis=1)
            f.write(f"Water t= {t * dt_frame:.5f} step= {t}\n{n_atoms:5d}\n")
            f.write("".join(p + fmt % tuple(r) for p, r in zip(prefixes, rows.tolist())))
            f.write("%10.5f%10.5f%10.5f\n" % tuple(np.asarray(box, float) * np.ones(3) / 10.0))


def write_extxyz(path, positions, box, every=10):
    """An extended XYZ of waters, 6 decimals in Angstrom, ``time=`` the step."""
    n_frames, n_atoms, _ = positions.shape
    names = [ELEMENTS[a % 3] for a in range(n_atoms)]
    lattice = " ".join(f"{v:.6f}" for v in np.diag(np.asarray(box, float) * np.ones(3)).ravel())
    with open(path, "w") as f:
        for t in range(n_frames):
            f.write(f'{n_atoms}\nLattice="{lattice}" '
                    f"Properties=species:S:1:pos:R:3 time={t * every}\n")
            f.write("".join("%s %.6f %.6f %.6f\n" % (n, *r)
                            for n, r in zip(names, positions[t].tolist())))


def write_trr(path, box, x=None, v=None, f=None, every=10, dt_frame=0.02,
              double=False, box_matrix=None):
    """A TRR: Angstrom in, nm written (forces kJ/mol/A in, kJ/mol/nm
    written), one frame a record of the XDR layout, ``step = t * every``."""
    arrays = [a for a in (x, v, f) if a is not None]
    n_frames, n_atoms, _ = arrays[0].shape
    fsize = 8 if double else 4
    dt = ">f8" if double else ">f4"
    scale = {0: 0.1, 1: 0.1, 2: 10.0}
    matrix = np.diag(np.asarray(box, float) * np.ones(3)) if box_matrix is None else box_matrix
    matrix = (np.asarray(matrix, float) / 10.0).astype(dt).tobytes()
    sizes = [n_atoms * 3 * fsize if a is not None else 0 for a in (x, v, f)]
    with open(path, "wb") as out:
        for t in range(n_frames):
            out.write(struct.pack(">ii", 1993, 13))
            out.write(struct.pack(">i", 12) + b"GMX_trn_file")
            out.write(struct.pack(">13i", 0, 0, 9 * fsize, 0, 0, 0, 0, *sizes,
                                  n_atoms, t * every, 0))
            out.write(struct.pack(">dd" if double else ">ff", t * dt_frame, 0.0))
            out.write(matrix)
            for k, a in enumerate((x, v, f)):
                if a is not None:
                    out.write((a[t] * scale[k]).astype(dt).tobytes())


def _record(payload, bo):
    n = struct.pack(bo + "i", len(payload))
    return n + payload + n


def write_dcd(path, positions, box, every=10, bo="<", fixed_atoms=0, flag_4d=0):
    """A CHARMM DCD with a unit cell: Angstrom, float32 X, Y and Z records."""
    n_frames, n_atoms, _ = positions.shape
    icntrl = [n_frames, 0, every, 0, 0, 0, 0, 0, fixed_atoms]
    header = (b"CORD" + struct.pack(bo + "9i", *icntrl) + struct.pack(bo + "f", 0.002)
              + struct.pack(bo + "10i", 1, flag_4d, 0, 0, 0, 0, 0, 0, 0, 24))
    box = np.asarray(box, float) * np.ones(3)
    cell = _record(struct.pack(bo + "6d", box[0], 0.0, box[1], 0.0, 0.0, box[2]), bo)
    f32 = np.dtype(np.float32).newbyteorder(bo)
    with open(path, "wb") as out:
        out.write(_record(header, bo))
        out.write(_record(struct.pack(bo + "i", 1) + b"water".ljust(80), bo))
        out.write(_record(struct.pack(bo + "i", n_atoms), bo))
        for t in range(n_frames):
            out.write(cell)
            for d in range(3):
                out.write(_record(positions[t, :, d].astype(f32).tobytes(), bo))
