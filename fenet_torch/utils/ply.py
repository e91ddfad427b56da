"""PLY point-cloud I/O for float32 x/y/z vertex clouds, ascii or
binary_little_endian (counterpart of ``fenet/utils/ply.py``)."""

from __future__ import annotations

import numpy as np

_HEADER = """ply
format {fmt} 1.0
element vertex {n}
property float x
property float y
property float z
end_header
"""


def _vertices(vertices: np.ndarray) -> np.ndarray:
    vertices = np.ascontiguousarray(vertices, np.float32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"expected (N, 3) vertices, got {vertices.shape}")
    return vertices


def binary_ply(vertices: np.ndarray) -> bytes:
    """The binary little-endian PLY file of an (N, 3) cloud."""
    vertices = _vertices(vertices)
    header = _HEADER.format(fmt="binary_little_endian", n=len(vertices))
    return header.encode() + vertices.astype("<f4").tobytes()


def export_pointcloud(vertices: np.ndarray, out_file: str, as_text: bool = True):
    if not as_text:
        with open(out_file, "wb") as f:
            f.write(binary_ply(vertices))
        return
    vertices = _vertices(vertices)
    with open(out_file, "w") as f:
        f.write(_HEADER.format(fmt="ascii", n=len(vertices)))
        np.savetxt(f, vertices, fmt="%.6g")


def load_pointcloud(in_file: str) -> np.ndarray:
    with open(in_file, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        n_props = sum(1 for l in header if l.startswith("property"))
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n, dtype=np.float32, ndmin=2)
        else:
            data = np.frombuffer(f.read(4 * n_props * n), dtype="<f4").reshape(n, n_props)
    return np.asarray(data[:, :3], np.float32)
