"""PLY I/O (binary little/big-endian + ascii), point clouds and meshes.

Counterpart of ``crfconv_tpu/data/ply.py``.

Functional replacement for the reference's PLY helpers
(utils/ply_utils.py:116-328): ``write_ply(filename, field_list, names)``
writes a 'vertex' element with named properties and, when
``triangular_faces`` is given, a 'face' element
(``property list uchar int vertex_indices``); ``read_ply`` returns a dict
name → column array, or ``(vertex_dict, faces)`` with
``triangular_mesh=True``.  List properties are supported on read for any
element (uniform-length lists are returned as a 2-D array, ragged ones as
an object array of rows).  Implemented from the PLY format spec; no
third-party plyfile dependency.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_NP_TO_PLY = {
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
    np.dtype("int32"): "int",
    np.dtype("int64"): "int",      # PLY has no int64; downcast
    np.dtype("uint8"): "uchar",
    np.dtype("int8"): "char",
    np.dtype("uint16"): "ushort",
    np.dtype("int16"): "short",
    np.dtype("uint32"): "uint",
}

_PLY_TO_NP = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def write_ply(
    filename: str,
    field_list: Union[np.ndarray, Sequence[np.ndarray]],
    field_names: Sequence[str],
    triangular_faces: Optional[np.ndarray] = None,
) -> bool:
    """Write columns as a binary PLY 'vertex' element (+ optional mesh).

    field_list: one array or a list of arrays; 2-D arrays contribute one
    property per column, in order, consuming names from field_names.
    triangular_faces: optional [F, 3] int array of triangle vertex ids,
    written as a 'face' element with ``property list uchar int
    vertex_indices`` (reference utils/ply_utils.py:260-328).
    """
    if not filename.endswith(".ply"):
        filename += ".ply"
    if isinstance(field_list, np.ndarray):
        field_list = [field_list]
    cols: List[np.ndarray] = []
    for f in field_list:
        f = np.asarray(f)
        if f.ndim == 1:
            cols.append(f)
        else:
            cols.extend(f[:, i] for i in range(f.shape[1]))
    if len(cols) != len(field_names):
        raise ValueError(
            f"{len(cols)} columns but {len(field_names)} names"
        )
    n = cols[0].shape[0]
    for c in cols:
        if c.shape[0] != n:
            raise ValueError("column length mismatch")

    fixed = []
    for c in cols:
        if c.dtype == np.int64:
            c = c.astype(np.int32)
        if c.dtype == np.float64:
            c = c.astype(np.float32)
        fixed.append(np.ascontiguousarray(c))
    cols = fixed

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for name, c in zip(field_names, cols):
        header.append(f"property {_NP_TO_PLY[c.dtype]} {name}")
    if triangular_faces is not None:
        triangular_faces = np.asarray(triangular_faces)
        if triangular_faces.ndim != 2 or triangular_faces.shape[1] != 3:
            raise ValueError("triangular_faces must be [F, 3]")
        header.append(f"element face {triangular_faces.shape[0]}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    rec = np.rec.fromarrays(cols, names=list(field_names))
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)
        if triangular_faces is not None:
            frec = np.empty(
                triangular_faces.shape[0],
                dtype=[("k", "u1"), ("v1", "<i4"), ("v2", "<i4"),
                       ("v3", "<i4")],
            )
            frec["k"] = 3
            frec["v1"] = triangular_faces[:, 0]
            frec["v2"] = triangular_faces[:, 1]
            frec["v3"] = triangular_faces[:, 2]
            frec.tofile(f)
    return True


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        # fixed props: (name, np dtype code); list props additionally carry
        # the count dtype: (name, item_code, count_code)
        self.props: List[tuple] = []

    @property
    def has_list(self) -> bool:
        return any(len(p) == 3 for p in self.props)


def _parse_header(f) -> Tuple[str, List[_Element]]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(_Element(tokens[1], int(tokens[2])))
        elif tokens[0] == "property":
            if not elements:
                raise ValueError("property before any element")
            if tokens[1] == "list":
                # property list <count_type> <item_type> <name>
                elements[-1].props.append(
                    (tokens[4], _PLY_TO_NP[tokens[3]], _PLY_TO_NP[tokens[2]])
                )
            else:
                elements[-1].props.append((tokens[2], _PLY_TO_NP[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt is None or not elements:
        raise ValueError("malformed PLY header")
    return fmt, elements


def _read_binary_element(f, el: _Element, ext: str) -> Dict[str, np.ndarray]:
    if not el.has_list:
        dtype = np.dtype([(name, ext + dt) for name, dt in el.props])
        rec = np.fromfile(f, dtype=dtype, count=el.count)
        if rec.shape[0] != el.count:
            raise ValueError(f"short read in element {el.name}")
        return {name: np.ascontiguousarray(rec[name]) for name, _ in el.props}

    # Element with list properties.  Fast path: a single list property and
    # uniform list length (the mesh 'face' case) — peek the first count and
    # read vectorized; fall back to a per-row scan otherwise.
    if len(el.props) == 1 and len(el.props[0]) == 3:
        name, item, cnt = el.props[0]
        start = f.tell()
        if el.count == 0:
            return {name: np.zeros((0, 0), dtype=np.dtype(ext + item))}
        first = np.fromfile(f, dtype=np.dtype(ext + cnt), count=1)
        L = int(first[0])
        f.seek(start)
        row = np.dtype([("k", ext + cnt), ("v", ext + item, (L,))])
        data = f.read(row.itemsize * el.count)
        if len(data) == row.itemsize * el.count:
            rec = np.frombuffer(data, dtype=row, count=el.count)
            if np.all(rec["k"] == L):
                return {name: np.ascontiguousarray(rec["v"])}
        f.seek(start)

    # general (possibly ragged / mixed) row-by-row scan
    out: Dict[str, list] = {name: [] for name, *_ in el.props}
    buf = f.read()
    off = 0
    for _ in range(el.count):
        for p in el.props:
            if len(p) == 3:
                name, item, cnt = p
                cdt = np.dtype(ext + cnt)
                k = int(np.frombuffer(buf, cdt, 1, off)[0])
                off += cdt.itemsize
                idt = np.dtype(ext + item)
                out[name].append(np.frombuffer(buf, idt, k, off).copy())
                off += idt.itemsize * k
            else:
                name, dt = p
                d = np.dtype(ext + dt)
                out[name].append(np.frombuffer(buf, d, 1, off)[0])
                off += d.itemsize
    f.seek(f.tell() - len(buf) + off)  # rewind past what later elements need
    result: Dict[str, np.ndarray] = {}
    for p in el.props:
        name = p[0]
        vals = out[name]
        if len(p) == 3:
            lens = {v.shape[0] for v in vals}
            if len(lens) <= 1:
                result[name] = (
                    np.stack(vals) if vals else np.zeros((0, 0))
                )
            else:
                arr = np.empty(len(vals), dtype=object)
                arr[:] = vals
                result[name] = arr
        else:
            result[name] = np.asarray(vals)
    return result


def _read_ascii_element(f, el: _Element) -> Dict[str, np.ndarray]:
    if not el.has_list:
        rows = []
        while len(rows) < el.count:
            tokens = f.readline().split()
            if tokens:
                rows.append([float(t) for t in tokens])
        data = np.asarray(rows, dtype=np.float64)
        return {
            name: data[:, i].astype(np.dtype(dt))
            for i, (name, dt) in enumerate(el.props)
        }
    out: Dict[str, list] = {p[0]: [] for p in el.props}
    done = 0
    while done < el.count:
        tokens = f.readline().split()
        if not tokens:
            continue
        pos = 0
        for p in el.props:
            if len(p) == 3:
                name, item, _ = p
                k = int(float(tokens[pos])); pos += 1
                vals = [float(t) for t in tokens[pos : pos + k]]
                pos += k
                out[name].append(np.asarray(vals, dtype=np.dtype(item)))
            else:
                name, dt = p
                out[name].append(np.dtype(dt).type(float(tokens[pos])))
                pos += 1
        done += 1
    result: Dict[str, np.ndarray] = {}
    for p in el.props:
        name = p[0]
        vals = out[name]
        if len(p) == 3:
            lens = {v.shape[0] for v in vals}
            if len(lens) <= 1:
                result[name] = np.stack(vals) if vals else np.zeros((0, 0))
            else:
                arr = np.empty(len(vals), dtype=object)
                arr[:] = vals
                result[name] = arr
        else:
            result[name] = np.asarray(vals)
    return result


def read_ply_elements(filename: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read every element of a PLY file → {element: {property: array}}.

    List properties with uniform length come back as [count, L] arrays
    (e.g. a mesh's ``vertex_indices`` as [F, 3]); ragged lists as object
    arrays of 1-D rows.
    """
    with open(filename, "rb") as f:
        fmt, elements = _parse_header(f)
        result: Dict[str, Dict[str, np.ndarray]] = {}
        for el in elements:
            if fmt == "ascii":
                result[el.name] = _read_ascii_element(f, el)
            else:
                ext = ">" if fmt == "binary_big_endian" else "<"
                result[el.name] = _read_binary_element(f, el, ext)
        return result


def read_ply(
    filename: str, triangular_mesh: bool = False
) -> Union[Dict[str, np.ndarray], Tuple[Dict[str, np.ndarray], np.ndarray]]:
    """Read a PLY file's 'vertex' element → dict name → array.

    With ``triangular_mesh=True`` additionally return the [F, 3] triangle
    array from the 'face' element (reference utils/ply_utils.py:116-196).
    """
    elements = read_ply_elements(filename)
    if "vertex" not in elements:
        raise ValueError("no vertex element")
    vertex = elements["vertex"]
    if not triangular_mesh:
        return vertex
    face = elements.get("face", {})
    faces = face.get("vertex_indices", face.get("vertex_index"))
    if faces is None:
        raise ValueError("no face element with vertex indices")
    return vertex, np.asarray(faces, dtype=np.int32)
