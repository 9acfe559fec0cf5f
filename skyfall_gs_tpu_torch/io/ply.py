"""Minimal self-contained PLY I/O (binary little-endian + ascii read).

Port of ``skyfall_gs_tpu/io/ply.py`` (numpy only, so the same code): a
single ``vertex`` element with float/uchar scalar properties, read into a
dict of numpy arrays and written from one.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Sequence

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1",
    "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2",
    "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4",
    "int": "<i4", "int32": "<i4",
}
_NP_TO_PLY = {
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
    np.dtype("uint8"): "uchar",
    np.dtype("int32"): "int",
    np.dtype("uint32"): "uint",
}


def read_ply(path: str, element: str = "vertex") -> Dict[str, np.ndarray]:
    """Read one element of a PLY file into {property_name: (N,) array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment":
                continue
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    raise ValueError("list properties are not supported")
                elements[-1][2].append((tokens[2], tokens[1]))
            elif tokens[0] == "end_header":
                break

        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"unsupported PLY format: {fmt}")

        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, _PLY_TO_NP[t]) for p, t in props])
            if fmt == "binary_little_endian":
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype,
                                     count=count)
            else:
                rows = [f.readline().split() for _ in range(count)]
                arr = np.array(rows, dtype=np.float64)
                data = np.zeros(count, dtype=dtype)
                for i, (p, _) in enumerate(props):
                    data[p] = arr[:, i]
            if name == element:
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
        if not out:
            raise ValueError(f"element '{element}' not found in {path}")
        return out


def write_ply(
    path: str,
    properties: Mapping[str, np.ndarray],
    order: Sequence[str] | None = None,
    element: str = "vertex",
) -> None:
    """Write a single-element binary PLY from {property: (N,) array}."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    names = list(order) if order is not None else list(properties.keys())
    n = len(next(iter(properties.values())))
    cols = []
    for name in names:
        arr = np.asarray(properties[name]).reshape(n)
        if arr.dtype not in _NP_TO_PLY:
            arr = arr.astype(np.float32)
        cols.append((name, arr))
    dtype = np.dtype([(name, arr.dtype.newbyteorder("<")) for name, arr in cols])
    rec = np.empty(n, dtype=dtype)
    for name, arr in cols:
        rec[name] = arr

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element {element} {n}\n".encode())
        for name, arr in cols:
            f.write(f"property {_NP_TO_PLY[np.dtype(arr.dtype.str[1:])]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
