"""Minimal PDB I/O for the surface-sampling workload (the port's own copy
of ``zelll_tpu/utils/pdb.py``).

Replaces the reference's pdbtbx usage (surface-sampling/src/io.rs:47-57):
parse ATOM/HETATM coordinates + element symbols (unsupported elements are
skipped, like Atom::try_from returning Err), and write sampled points back
out as HETATM records (examples/cli.rs:124-143 writes the trace as PDB).
"""

from __future__ import annotations

import numpy as np

from ..models.sdf import ELEMENT_RADII

__all__ = ["read_pdb", "write_points_pdb"]


def read_pdb(path) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Parse a PDB file -> (positions (n,3) f64, radii (n,), elements).

    Atoms whose element is not in the supported table (C/H/O/N/S/Se,
    io.rs:14-24) are skipped.
    """
    positions, radii, elements = [], [], []
    with open(path) as f:
        for line in f:
            if not (line.startswith("ATOM") or line.startswith("HETATM")):
                continue
            # columns per PDB v3.3: x 31-38, y 39-46, z 47-54, element 77-78
            try:
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
            except (ValueError, IndexError):
                continue
            elem = line[76:78].strip().upper()
            if not elem:
                # fall back to the first letter of the atom name
                elem = line[12:16].strip().lstrip("0123456789")[:1].upper()
            if elem not in ELEMENT_RADII:
                continue
            positions.append([x, y, z])
            radii.append(ELEMENT_RADII[elem])
            elements.append(elem)
    return (
        np.asarray(positions, np.float64).reshape(-1, 3),
        np.asarray(radii, np.float64),
        elements,
    )


def write_points_pdb(path, points: np.ndarray, element: str = "C") -> None:
    """Write sampled points as HETATM records (one model)."""
    points = np.asarray(points)
    with open(path, "w") as f:
        for i, (x, y, z) in enumerate(points, start=1):
            serial = i % 100000
            f.write(
                f"HETATM{serial:5d}  {element:<3s}PTS A{(i % 10000):4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          "
                f"{element:>2s}\n"
            )
        f.write("END\n")
