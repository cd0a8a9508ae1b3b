"""Per-frame spatial sorts and the neighbor extract's windows.

Counterpart of the sorted route of ``lammps_analysis_tpu/ops/pallas_adf.py``
(``_spatial_sort`` :766, ``_brick_sort`` :794, ``_chunk_arcs`` :896,
``_arcs_from_flags`` :920, ``_chunk_skip_bitmap`` :982, ``_chunk_window``
:1043, ``window_chunk_bound`` :1089, ``brick_window_bound`` :1104), in torch
on the frames' device, at the CUDA sweep's granularity: a block of
``BLOCK_CENTERS`` consecutive sorted centers takes one list of arcs, each arc
a circular run of chunks of ``CHUNK_ATOMS`` sorted atoms
(``csrc/adf_neighbor_extract.cu`` says why 32 and 32; the TPU kernel's chunks
were 128 lanes).

A sort reorders each frame's atoms so that the neighbors of a block of
consecutive centers lie in few runs of the order: by z (one run, circular at
the periodic seam), or by (z-slab, serpentine y) (a few runs). Invalid atoms
(ids outside ``[0, n_species)``) sort last. The windows are conservative: a
chunk is skipped only when the minimum-image gap between the block's and the
chunk's bounding boxes exceeds the cutoff, computed in float64, so no pair
inside the cutoff is ever dropped, whatever the order; the order only decides
how narrow the windows are. The gap is taken over the axes the sort orders
(z, or y and z), where the JAX package takes all three: the gap over fewer
axes is never larger, so the flags are a superset of the three-axis flags,
and a chunk of the z or brick order spans the box's width along the axes left
out, where the gap is 0 almost always. It costs a third (two thirds) of the
elementwise passes, and under the z sort the flags of a block are always one
circular run.
"""

from __future__ import annotations

import numpy as np
import torch

#: centers of one block of the sweep (``kCentersPerBlock`` in the kernel)
BLOCK_CENTERS = 32
#: atoms of one window chunk (``kChunk`` in the kernel)
CHUNK_ATOMS = 32
#: arcs a block of the brick sort takes (the JAX package's ``n_arcs``)
BRICK_ARCS = 6
#: elements of the largest (rows, chunks) intermediate of the bitmap
_BLOCK_ELEMENTS = 2**24


def _per_frame_ids(species_id: torch.Tensor, n_frames: int) -> torch.Tensor:
    if species_id.dim() == 1:
        return species_id.expand(n_frames, -1)
    return species_id


def _sort_by(positions, species_id, n_species, key):
    """Frames and their ids in ascending ``key`` per frame, invalid atoms
    last; ties in atom order. Returns ``(pos_s, sid_s, order)``."""
    sid2 = _per_frame_ids(species_id, positions.shape[0])
    valid = (sid2 >= 0) & (sid2 < n_species)
    key = torch.where(valid, key, torch.full_like(key, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    pos_s = torch.gather(positions, 1, order[..., None].expand(-1, -1, 3)).contiguous()
    sid_s = torch.gather(sid2, 1, order).contiguous()
    return pos_s, sid_s, order


def spatial_sort(positions: torch.Tensor, species_id: torch.Tensor, n_species: int):
    """Each frame sorted along z. Returns ``(pos_s (F, N, 3), sid_s (F, N),
    order (F, N))`` with ``pos_s[f] = positions[f, order[f]]``.

    A block's in-cutoff atoms then lie in one circular run of the order (the
    ~2 cutoff slab around its z), which wraps at the periodic seam.
    """
    return _sort_by(positions, species_id, n_species, positions[..., 2])


def brick_sort(positions, species_id, n_species: int, box, cutoff: float):
    """Each frame sorted by (z-slab, serpentine y), as the JAX ``_brick_sort``.

    Slabs are ``box_z / floor(box_z / cutoff) >= cutoff`` thick, so a
    center's neighbors lie in at most 3 consecutive slabs, inside each of
    which they occupy one y-window; odd slabs run y downwards, so a block
    that straddles a slab seam holds y-neighbors of both slabs. Returns
    ``(pos_s, sid_s, order)`` as :func:`spatial_sort`.
    """
    # float32 scalars on the host: a host-to-device copy of the box would
    # synchronise the stream with the work queued before the sort
    b = np.asarray(box, np.float32).reshape(3)
    n_slabs = max(np.floor(b[2] / np.float32(cutoff)), np.float32(1.0))
    slab_w = float(b[2] / n_slabs)
    z = torch.clamp(positions[..., 2], 0.0, float(b[2] * np.float32(1 - 1e-7)))
    slab = torch.clamp(torch.floor(z / slab_w), max=float(n_slabs - 1))
    y = positions[..., 1]
    odd = torch.remainder(slab, 2.0) >= 1.0
    y_eff = torch.where(odd, float(b[1]) - y, y)
    key = slab * float(2 * b[1]) + y_eff
    return _sort_by(positions, species_id, n_species, key)


def _bboxes(p: torch.Tensor, valid: torch.Tensor, rows: int):
    """Centers and half-extents ``(F, groups, 3)`` float64 of consecutive
    groups of ``rows`` atoms; an empty group gets an inverted box whose gap
    to anything is huge."""
    f, n, _ = p.shape
    big = 3e9
    p = p.view(f, n // rows, rows, 3)
    v = valid.view(f, n // rows, rows, 1)
    lo = torch.where(v, p, big).amin(2)
    hi = torch.where(v, p, -big).amax(2)
    return (lo + hi) * 0.5, (hi - lo) * 0.5


def chunk_skip_bitmap(pos_s, sid_s, n_species: int, box, cutoff: float, split: int = 1,
                      axes=(0, 1, 2)):
    """``(F * n_blocks, n_chunks)`` bool: which chunks a block must test.

    Conservative (JAX ``_chunk_skip_bitmap``): a chunk is skipped only if the
    minimum-image gap along ``axes`` between the bounding boxes of the
    block's valid centers and the chunk's valid atoms exceeds the cutoff
    (with 1e-5 of slack on its square), in float64. ``split`` cuts each block
    into that many sub-blocks and ORs their flags: under the brick sort a
    block straddling a slab seam gets two tight boxes instead of one spanning
    the slabs.
    """
    f, n, _ = pos_s.shape
    n_blocks = -(-n // BLOCK_CENTERS)
    n_chunks = -(-n // CHUNK_ATOMS)
    n_pad = max(n_blocks * BLOCK_CENTERS, n_chunks * CHUNK_ATOMS)
    p = pos_s.to(torch.float64)
    valid = (sid_s >= 0) & (sid_s < n_species)
    if n_pad != n:
        p = torch.nn.functional.pad(p, (0, 0, 0, n_pad - n))
        valid = torch.nn.functional.pad(valid, (0, n_pad - n), value=False)
    rows_c = BLOCK_CENTERS // split if BLOCK_CENTERS % split == 0 else BLOCK_CENTERS
    cb, hb = _bboxes(p, valid, rows_c)  # (F, n_blocks * BLOCK_CENTERS // rows_c, 3)
    cc, hc = _bboxes(p, valid, CHUNK_ATOMS)
    cb, hb = cb[:, : n_blocks * BLOCK_CENTERS // rows_c], hb[:, : n_blocks * BLOCK_CENTERS // rows_c]
    cc, hc = cc[:, :n_chunks], hc[:, :n_chunks]
    edges = [float(x) for x in np.asarray(box, np.float64).reshape(3)]  # no host-to-device copy
    limit = float(cutoff) ** 2 * (1.0 + 1e-5)
    n_rows = cb.shape[1]
    step = max(1, _BLOCK_ELEMENTS // max(f * n_chunks, 1))
    process = torch.empty((f, n_rows, n_chunks), dtype=torch.bool, device=p.device)
    for r0 in range(0, n_rows, step):
        r1 = min(r0 + step, n_rows)
        gap2 = None
        for axis in axes:
            dd = cb[:, r0:r1, None, axis] - cc[:, None, :, axis]
            dd -= edges[axis] * torch.round(dd / edges[axis])
            gap = torch.clamp_(dd.abs_() - (hb[:, r0:r1, None, axis] + hc[:, None, :, axis]), min=0.0)
            gap2 = gap.square_() if gap2 is None else gap2.addcmul_(gap, gap)
        process[:, r0:r1] = gap2 <= limit
    if rows_c != BLOCK_CENTERS:
        process = process.view(f, n_blocks, BLOCK_CENTERS // rows_c, n_chunks).any(2)
    return process.reshape(f * n_blocks, n_chunks)


def chunk_window(pos_s, sid_s, n_species: int, box, cutoff: float):
    """``(F * n_blocks, 2)`` int32 ``(start, count)``: each block's one
    circular arc of chunks (JAX ``_chunk_window``), for z-sorted frames.

    Under the z sort a block's flags (along z) form one circular arc; the
    arc is the run that starts at the first 0 -> 1 step. Where the flags are
    not one arc, the window is the whole frame: conservative, never lossy.
    """
    flags = chunk_skip_bitmap(pos_s, sid_s, n_species, box, cutoff, axes=(2,)).to(torch.int32)
    _, c = flags.shape
    prev = torch.roll(flags, 1, dims=1)
    run_start = (flags == 1) & (prev == 0)
    start = torch.argmax(run_start.to(torch.int32), dim=1)
    count = flags.sum(1)
    ar = torch.arange(c, device=flags.device)[None, :]
    arc = torch.remainder(ar - start[:, None], c) < count[:, None]
    ok = ((flags == 0) | arc).all(1)
    start = torch.where(ok, start, 0)
    count = torch.where(ok, count, c)
    return torch.stack([start, count], dim=1).to(torch.int32)


def arcs_from_flags(flags: torch.Tensor, n_arcs: int):
    """Cover each flag row by at most ``n_arcs`` circular arcs (JAX
    ``_arcs_from_flags``): keep the ``n_arcs`` longest circular zero-runs
    open and sweep everything else, the smallest such cover. Returns
    ``(arcs (rows, 2 n_arcs) int32, total (rows,) int32)``: ``(start,
    count)`` pairs, unused ones ``(0, 0)``, and the chunks each row covers."""
    r, c = flags.shape
    if n_arcs > c:  # fewer chunks than arcs
        arcs, total = arcs_from_flags(flags, c)
        pad = torch.zeros((r, 2 * (n_arcs - c)), dtype=arcs.dtype, device=arcs.device)
        return torch.cat([arcs, pad], dim=1), total
    on = flags.bool()
    any_on = on.any(1)
    all_on = on.all(1)
    cat = torch.cat([on, on], dim=1)
    iota2 = torch.arange(2 * c, device=flags.device)[None, :]
    next_one = torch.where(cat, iota2, 2 * c)
    # position (in doubled coordinates) of the next set flag at or after each
    next_one = torch.flip(torch.cummin(torch.flip(next_one, [1]), dim=1).values, [1])[:, :c]
    prev_on = torch.roll(on, 1, dims=1)
    gap_start = ~on & prev_on
    iota = torch.arange(c, device=flags.device)[None, :]
    gap_len = torch.where(gap_start, next_one - iota, 0)
    top_len, top_pos = torch.topk(gap_len, n_arcs, dim=1)
    kept = top_len > 0
    pos_sorted = torch.sort(torch.where(kept, top_pos, 2 * c), dim=1).values
    len_by_pos = torch.gather(gap_len, 1, torch.clamp(pos_sorted, max=c - 1))
    k_gaps = kept.sum(1)
    idx = torch.arange(n_arcs, device=flags.device)[None, :]
    valid = idx < k_gaps[:, None]
    nxt = torch.where(idx + 1 < k_gaps[:, None], idx + 1, torch.zeros_like(idx))
    start = torch.where(valid, torch.remainder(pos_sorted + len_by_pos, c), 0)
    next_gap_start = torch.gather(pos_sorted, 1, nxt)
    count = torch.where(valid, torch.remainder(next_gap_start - start, c), 0)
    first = idx == 0
    count = torch.where((k_gaps[:, None] == 0) & first & all_on[:, None], c, count)
    count = torch.where(~any_on[:, None], 0, count)
    arcs = torch.stack([start, count], dim=2).reshape(r, 2 * n_arcs).to(torch.int32)
    return arcs, count.sum(1).to(torch.int32)


def chunk_arcs(pos_s, sid_s, n_species: int, box, cutoff: float, n_arcs: int = BRICK_ARCS):
    """Each block's flags covered by at most ``n_arcs`` arcs (JAX
    ``_chunk_arcs``, split 2), for brick-sorted frames: ``(arcs, total)``
    as :func:`arcs_from_flags`."""
    flags = chunk_skip_bitmap(pos_s, sid_s, n_species, box, cutoff, split=2, axes=(1, 2))
    return arcs_from_flags(flags, n_arcs)


def window_chunk_bound(n_atoms: int, box, cutoff: float) -> int:
    """Bound on a block's window, in chunks, under the z sort (JAX
    ``window_chunk_bound``): 1.5 times the uniform-density share
    ``2.1 cutoff / L_z`` of the chunks, plus 3; at most every chunk. A
    block in a z-sparse region can exceed it (the extract's overflow)."""
    n_chunks = -(-n_atoms // CHUNK_ATOMS)
    lz = float(np.asarray(box, np.float64).reshape(3)[2])
    frac = min(1.0, 2.1 * float(cutoff) / max(lz, 1e-30))
    return int(min(n_chunks, np.ceil(1.5 * frac * n_chunks) + 3))


def brick_window_bound(n_atoms: int, box, cutoff: float, n_arcs: int = BRICK_ARCS) -> int:
    """Bound on a block's total window, in chunks, under the brick sort (JAX
    ``brick_window_bound``): 3 slabs, each with the y-window ``2.1 cutoff /
    L_y`` of its chunks plus 2, times 1.8, plus slack of ``n_arcs + 2``."""
    n_chunks = -(-n_atoms // CHUNK_ATOMS)
    b = np.asarray(box, np.float64).reshape(3)
    n_slabs = max(1, int(b[2] // float(cutoff)))
    y_frac = min(1.0, 2.1 * float(cutoff) / max(b[1], 1e-30))
    per_slab = y_frac * n_chunks / n_slabs + 2.0
    return int(min(n_chunks, np.ceil(1.8 * 3.0 * per_slab) + n_arcs + 2))


def window_bound(sort: str, n_atoms: int, box, cutoff: float) -> int:
    """The bound on a block's window under ``sort`` (``"z"`` or ``"brick"``)."""
    if sort == "z":
        return window_chunk_bound(n_atoms, box, cutoff)
    if sort == "brick":
        return brick_window_bound(n_atoms, box, cutoff)
    raise ValueError(f"sort must be 'z' or 'brick', got {sort!r}")


def sort_frames(positions, species_id, n_species: int, box, cutoff: float, sort: str):
    """``(pos_s, sid_s, order, windows, total)`` of the sorted route: the
    frames sorted by ``sort`` (``"z"`` or ``"brick"``), each block's arcs
    ``(F * n_blocks, 2 n_arcs)`` int32 and the chunks each block covers."""
    if sort == "z":
        pos_s, sid_s, order = spatial_sort(positions, species_id, n_species)
        windows = chunk_window(pos_s, sid_s, n_species, box, cutoff)
        return pos_s, sid_s, order, windows, windows[:, 1]
    if sort == "brick":
        pos_s, sid_s, order = brick_sort(positions, species_id, n_species, box, cutoff)
        windows, total = chunk_arcs(pos_s, sid_s, n_species, box, cutoff)
        return pos_s, sid_s, order, windows, total
    raise ValueError(f"sort must be 'z' or 'brick', got {sort!r}")
