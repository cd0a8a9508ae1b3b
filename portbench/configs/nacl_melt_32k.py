"""Positions of ``nacl_melt_32k`` from a seed: uniform at molten NaCl's
density at 1400 K and walked from frame to frame, wrapped into the box, on
the card."""

from portbench import walk


def generate(config: dict, seed: int, device: str):
    """``(n_frames, n_atoms, 3)`` float32 on ``device``: Na's ions, then Cl's."""
    return walk.wrapped_walk(
        n_frames=config["n_frames"],
        n_atoms=sum(config["species"].values()),
        box=config["box_length"],
        sigma=config["walk_sigma"],
        seed=seed,
        device=device,
    )
