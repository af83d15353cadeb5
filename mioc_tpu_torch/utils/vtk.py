"""Pure-Python legacy-ASCII VTK writer and ParaView PVD collections.

Counterpart of ``mioc_tpu.utils.vtk``, its own copy of the numpy code: the
same mesh and data give the same bytes (the header line included).
Capability parity with the reference's WriteVTK usage
(the reference's ``julia_opt/julia_fem/write_vtk.jl``): triangle meshes with
named point/cell scalar and vector fields, plus time-series ``.pvd``
collections.  No external dependency — the legacy VTK format is a text file.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_vtk", "PVDCollection", "pvd_append"]


def write_vtk(filename, mesh, data=None):
    """Write ``<filename>.vtk`` (legacy ASCII unstructured grid).

    ``data`` may be None, an array (named "u"), a ``(name, array)`` pair, or a
    list of pairs (write_vtk.jl:1-33 semantics).  Point arrays have length
    ``np`` (or ``(3, np)`` for vectors); cell arrays have length ``ntri``.
    """
    if not filename.endswith(".vtk"):
        filename = filename + ".vtk"
    p = np.asarray(mesh.p, float)
    if p.shape[1] == 2:
        p = np.concatenate([p, np.zeros((len(p), 1))], axis=1)
    t = np.asarray(mesh.t)

    if data is None:
        fields = []
    elif isinstance(data, (list,)):
        fields = [(k, np.asarray(v)) for k, v in data]
    elif isinstance(data, tuple) and len(data) == 2 and isinstance(data[0], str):
        fields = [(data[0], np.asarray(data[1]))]
    else:
        fields = [("u", np.asarray(data))]

    with open(filename, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\nmioc_tpu output\nASCII\n")
        fh.write("DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {len(p)} double\n")
        for row in p:
            fh.write(f"{row[0]} {row[1]} {row[2]}\n")
        fh.write(f"\nCELLS {len(t)} {4 * len(t)}\n")
        for row in t:
            fh.write(f"3 {row[0]} {row[1]} {row[2]}\n")
        fh.write(f"\nCELL_TYPES {len(t)}\n")
        fh.write("\n".join(["5"] * len(t)) + "\n")

        is_point = [
            v.size in (len(p), 3 * len(p)) and v.shape[-1] != len(t)
            for _, v in fields
        ]
        point_fields = [f for f, ip in zip(fields, is_point) if ip]
        cell_fields = [f for f, ip in zip(fields, is_point) if not ip]
        if point_fields:
            fh.write(f"\nPOINT_DATA {len(p)}\n")
            for k, v in point_fields:
                if v.ndim == 2:  # vector field (3, np) or (np, 3)
                    vv = v if v.shape[0] == len(p) else v.T
                    fh.write(f"VECTORS {k} double\n")
                    for row in vv:
                        fh.write(f"{row[0]} {row[1]} {row[2] if len(row) > 2 else 0.0}\n")
                else:
                    fh.write(f"SCALARS {k} double 1\nLOOKUP_TABLE default\n")
                    fh.write("\n".join(str(x) for x in v.ravel()) + "\n")
        if cell_fields:
            fh.write(f"\nCELL_DATA {len(t)}\n")
            for k, v in cell_fields:
                fh.write(f"SCALARS {k} double 1\nLOOKUP_TABLE default\n")
                fh.write("\n".join(str(x) for x in v.ravel()) + "\n")
    return filename


class PVDCollection:
    """ParaView time-series collection (pvd_append, write_vtk.jl:35-40)."""

    def __init__(self, path):
        self.path = path if path.endswith(".pvd") else path + ".pvd"
        self.entries = []

    def append(self, time, vtk_file):
        self.entries.append((float(time), os.path.basename(vtk_file)))

    def write(self):
        with open(self.path, "w") as fh:
            fh.write('<?xml version="1.0"?>\n')
            fh.write('<VTKFile type="Collection" version="0.1">\n<Collection>\n')
            for tm, f in self.entries:
                fh.write(f'  <DataSet timestep="{tm}" part="0" file="{f}"/>\n')
            fh.write("</Collection>\n</VTKFile>\n")
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.write()


def pvd_append(pvd: PVDCollection, time, mesh, data):
    n = len(pvd.entries) + 1
    fname = pvd.path[:-4] + f"_{n}.vtk"
    write_vtk(fname, mesh, data)
    pvd.append(time, fname)
    return fname
