"""PLY point-cloud IO for 3D Gaussian Splatting scenes.

Equivalent of the reference's hapPLY-based loader
(ResourceManager::loadGaussians, ResourceManager.cpp:167-300).  Hand-rolled
reader (no external dependency): parses the header, memory-maps the body, and
returns per-property numpy columns — then `models.gaussians.from_raw_ply_columns`
applies the reference's activation transforms.

Supports `format ascii 1.0` and `format binary_little_endian 1.0`, scalar
properties only (list properties are rejected — gaussian clouds never use
them).  A writer is provided for building test fixtures.

A native C++ fast path (native/gsply.cpp) is used automatically for large
binary files when the shared library has been built; this mirrors the
reference's C++ loader layer.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass

import numpy as np

_PLY_DTYPES = {
    "char": np.int8,
    "int8": np.int8,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "short": np.int16,
    "int16": np.int16,
    "ushort": np.uint16,
    "uint16": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
    "uint32": np.uint32,
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
}


@dataclass
class PlyElement:
    name: str
    count: int
    properties: list[tuple[str, np.dtype]]
    data: dict[str, np.ndarray]

    def column(self, name: str) -> np.ndarray:
        if name not in self.data:
            raise KeyError(f"ply element '{self.name}' has no property '{name}'")
        return self.data[name]


@dataclass
class PlyData:
    fmt: str
    elements: list[PlyElement]

    def element(self, name: str | None = None) -> PlyElement:
        if name is None:
            return self.elements[0]
        for e in self.elements:
            if e.name == name:
                return e
        raise KeyError(f"no ply element named '{name}'")


def _parse_header(stream: io.BufferedReader):
    magic = stream.readline().strip()
    if magic != b"ply":
        raise ValueError("not a ply file (missing 'ply' magic)")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, np.dtype]]]] = []
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("unexpected EOF in ply header")
        tokens = line.decode("ascii").strip().split()
        if not tokens:
            continue
        if tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
            if fmt not in ("ascii", "binary_little_endian"):
                raise ValueError(f"unsupported ply format: {fmt}")
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                raise ValueError("list properties are not supported")
            if not elements:
                raise ValueError("property before element in ply header")
            dtype = _PLY_DTYPES.get(tokens[1])
            if dtype is None:
                raise ValueError(f"unknown ply type: {tokens[1]}")
            elements[-1][2].append((tokens[2], np.dtype(dtype)))
        elif tokens[0] == "end_header":
            break
        else:
            raise ValueError(f"unknown ply header line: {line!r}")
    if fmt is None:
        raise ValueError("ply header missing 'format' line")
    return fmt, elements


def read_ply(path: str | os.PathLike) -> PlyData:
    """Read a ply file into per-property numpy columns."""
    with open(path, "rb") as f:
        fmt, header_elements = _parse_header(f)
        body_offset = f.tell()
        elements = []
        if fmt == "binary_little_endian":
            for name, count, props in header_elements:
                record = np.dtype([(p, d.newbyteorder("<")) for p, d in props])
                raw = np.fromfile(f, dtype=record, count=count)
                if raw.shape[0] != count:
                    raise ValueError(
                        f"ply element '{name}': expected {count} records, "
                        f"got {raw.shape[0]}"
                    )
                data = {p: np.ascontiguousarray(raw[p]) for p, _ in props}
                elements.append(PlyElement(name, count, props, data))
        else:  # ascii
            text = f.read().decode("ascii").split()
            cursor = 0
            for name, count, props in header_elements:
                ncols = len(props)
                chunk = text[cursor : cursor + count * ncols]
                cursor += count * ncols
                arr = np.array(chunk, dtype=np.float64).reshape(count, ncols)
                data = {
                    p: arr[:, i].astype(d) for i, (p, d) in enumerate(props)
                }
                elements.append(PlyElement(name, count, props, data))
        del body_offset
        return PlyData(fmt, elements)


def write_ply(
    path: str | os.PathLike,
    columns: dict[str, np.ndarray],
    *,
    element_name: str = "vertex",
    binary: bool = True,
) -> None:
    """Write scalar float32 columns as a ply file (test-fixture writer)."""
    names = list(columns.keys())
    count = len(next(iter(columns.values())))
    for n in names:
        if len(columns[n]) != count:
            raise ValueError("all ply columns must have equal length")
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header.append(f"element {element_name} {count}")
    for n in names:
        header.append(f"property float {n}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            record = np.dtype([(n, "<f4") for n in names])
            out = np.empty(count, dtype=record)
            for n in names:
                out[n] = np.asarray(columns[n], dtype=np.float32)
            out.tofile(f)
        else:
            mat = np.stack(
                [np.asarray(columns[n], dtype=np.float32) for n in names], axis=1
            )
            for row in mat:
                f.write((" ".join(repr(float(v)) for v in row) + "\n").encode())


def write_gaussian_ply(path: str | os.PathLike, table) -> None:
    """Export a GaussianTable as a capture-format binary .ply.

    Property order follows the reference's expectations
    (ResourceManager.cpp:176-222): x y z, scale_0..2, rot_0..3, opacity,
    f_dc_0..2, f_rest_0..44 — so the exported file round-trips through
    `load_gaussians` (incl. the native fast path) like a real trained
    capture.
    """
    from ..models.gaussians import raw_ply_columns_from_table

    raw = raw_ply_columns_from_table(table)
    columns: dict[str, np.ndarray] = {}
    for i, name in enumerate(("x", "y", "z")):
        columns[name] = raw["xyz"][:, i]
    for i in range(3):
        columns[f"scale_{i}"] = raw["scales"][:, i]
    for i in range(4):
        columns[f"rot_{i}"] = raw["rots"][:, i]
    columns["opacity"] = raw["opacities"]
    for i in range(3):
        columns[f"f_dc_{i}"] = raw["f_dc"][:, i]
    for i in range(45):
        columns[f"f_rest_{i}"] = raw["f_rest"][:, i]
    write_ply(path, columns, binary=True)


def gaussian_columns_from_ply(path: str | os.PathLike):
    """Extract the 59 gaussian-splatting property columns from a ply file.

    Property set and ordering follow ResourceManager.cpp:176-222:
    x y z, scale_0..2, rot_0..3, opacity, f_dc_0..2, f_rest_0..44.
    """
    element = read_ply(path).element()

    def col(name):
        return element.column(name).astype(np.float32)

    xyz = np.stack([col("x"), col("y"), col("z")], axis=1)
    scales = np.stack([col("scale_0"), col("scale_1"), col("scale_2")], axis=1)
    rots = np.stack([col(f"rot_{i}") for i in range(4)], axis=1)
    opacities = col("opacity")
    f_dc = np.stack([col("f_dc_0"), col("f_dc_1"), col("f_dc_2")], axis=1)
    have_rest = all(
        any(p == f"f_rest_{i}" for p, _ in element.properties) for i in range(45)
    )
    if have_rest:
        f_rest = np.stack([col(f"f_rest_{i}") for i in range(45)], axis=1)
    else:
        f_rest = np.zeros((element.count, 45), dtype=np.float32)
    return dict(
        xyz=xyz,
        scales=scales,
        rots=rots,
        opacities=opacities,
        f_dc=f_dc,
        f_rest=f_rest,
    )


def load_gaussians(path: str | os.PathLike, *, morton_sort: bool = True):
    """Load a .ply gaussian cloud into a GaussianTable.

    Equivalent of ResourceManager::loadGaussians (ResourceManager.cpp:167-300):
    parse columns, apply activations, Morton-sort.

    The Morton order exists for cache coherency of the blend's
    feature fetches by index.  `morton_sort=False` keeps file order — the
    gaussian order is semantically free (it only breaks exact (tile, depth)
    ties, which the reference leaves nondeterministic).
    """
    from ..models.gaussians import from_raw_ply_columns
    from ..native import runtime as native_runtime

    native = native_runtime.try_load_gaussians(path)
    if native is not None:
        return from_raw_ply_columns(morton_sort=morton_sort, **native)
    cols = gaussian_columns_from_ply(path)
    return from_raw_ply_columns(morton_sort=morton_sort, **cols)
