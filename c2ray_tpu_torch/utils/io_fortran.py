"""Fortran binary I/O: unformatted sequential records and the sm3d cube
format (a copy of c2ray_tpu/utils/io_fortran.py; numpy only).

Byte-exact re-implementation of the reference's file formats so its
outputs/inputs and post-processing tools interoperate unchanged:
  - Fortran unformatted sequential records: 4-byte length marker +
    payload + 4-byte length marker (gfortran convention).
  - sm3d cubes (read_sm3d.f90): record 1 = three int32
    mesh sizes, record 2 = the whole array (float64 "dp" or float32 "si"
    variants), Fortran (column-major) order.
  - stream-access files (densityaccess="stream",
    nbody_test.F90:74-77): raw header + data without record markers.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np


# gfortran splits unformatted sequential records larger than this into
# SUBRECORDS: the leading marker of every subrecord but the last is the
# NEGATIVE of its length (record continues), and the trailing marker of
# every subrecord but the first is negative (record continues backward).
# Production cubes exceed 2 GiB (864^3 f64 = 5.2 GB), so the reference's
# own gfortran-written files use this framing — reproduced here.
_SUBRECORD_MAX = 2147483639


def _sub_lengths(total: int) -> List[int]:
    if total <= _SUBRECORD_MAX:
        return [total]
    k, rem = divmod(total, _SUBRECORD_MAX)
    return [_SUBRECORD_MAX] * k + ([rem] if rem else [])


def read_unformatted_records(path: str) -> List[bytes]:
    """Read all records of a Fortran unformatted sequential file
    (subrecord continuation markers included)."""
    out = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (n,) = struct.unpack("<i", head)
            parts = []
            while True:
                sub = abs(n)
                payload = f.read(sub)
                tail = f.read(4)
                if len(payload) != sub or \
                        abs(struct.unpack("<i", tail)[0]) != sub:
                    raise IOError(f"corrupt Fortran record in {path}")
                parts.append(payload)
                if n >= 0:          # last (or only) subrecord
                    break
                (n,) = struct.unpack("<i", f.read(4))
            out.append(b"".join(parts))
    return out


def write_unformatted_records(path: str, records: List[bytes]) -> None:
    with open(path, "wb") as f:
        for payload in records:
            subs = _sub_lengths(len(payload))
            off = 0
            for i, sub in enumerate(subs):
                lead = sub if i == len(subs) - 1 else -sub
                trail = sub if i == 0 else -sub
                f.write(struct.pack("<i", lead))
                f.write(payload[off:off + sub])
                f.write(struct.pack("<i", trail))
                off += sub


def write_sm3d(path: str, array: np.ndarray, dtype=np.float64) -> None:
    """Write a 3D cube in sm3d format (write_sm3d_*_file_routine,
    read_sm3d.f90:63-104): header record (m1,m2,m3 int32) + data record
    in Fortran order."""
    a = np.asarray(array)
    header = np.asarray(a.shape, np.int32).tobytes()
    data = np.asfortranarray(a.astype(dtype)).tobytes(order="F")
    write_unformatted_records(path, [header, data])


def read_sm3d(path: str, dtype=np.float64,
              expect_mesh: Tuple[int, int, int] = None) -> np.ndarray:
    """Read an sm3d cube; validates the mesh header like the reference
    (read_sm3d.f90:22-27, density_module.F90:217-223)."""
    recs = read_unformatted_records(path)
    mesh = np.frombuffer(recs[0], np.int32)
    if expect_mesh is not None and tuple(mesh) != tuple(expect_mesh):
        raise ValueError(f"{path}: mesh {tuple(mesh)} != expected {expect_mesh}")
    a = np.frombuffer(recs[1], dtype).reshape(tuple(mesh), order="F")
    return np.ascontiguousarray(a)


def read_sm3d_slab(path: str, dtype, mesh: Tuple[int, int, int],
                   row0: int, nrows: int) -> np.ndarray:
    """Read grid-axis-0 rows [row0, row0+nrows) of an sm3d cube without
    materializing the rest (the file is seekable; the halo layout's
    per-process slab ingestion relies on this).  Returns a C-order
    (nrows, n2, n3) slab."""
    with open(path, "rb") as f:
        head = f.read(4)
        (nh,) = struct.unpack("<i", head)
        m = np.frombuffer(f.read(nh), np.int32)
        if tuple(m) != tuple(mesh):
            raise ValueError(f"{path}: mesh {tuple(m)} != expected {mesh}")
        f.read(4)
        (lead,) = struct.unpack("<i", f.read(4))   # data record marker
        data_off = f.tell()
        if lead < 0:
            # > 2 GiB data record: gfortran subrecord markers interrupt
            # the payload, so the flat memmap view does not exist.
            # Stream logical z-planes (contiguous in Fortran order)
            # through a marker-stripping reader and keep the slab rows —
            # one plane resident, full-file read (restart path only).
            n1, n2, n3 = mesh
            itemsize = np.dtype(dtype).itemsize
            plane = n1 * n2 * itemsize
            out = np.empty((nrows, n2, n3), dtype)
            remaining = abs(lead)
            for k in range(n3):
                need = plane
                parts = []
                while need:
                    if remaining == 0:
                        f.read(4)                   # trailing marker
                        (nxt,) = struct.unpack("<i", f.read(4))
                        remaining = abs(nxt)
                    take = min(need, remaining)
                    parts.append(f.read(take))
                    need -= take
                    remaining -= take
                pl = np.frombuffer(b"".join(parts), dtype).reshape(
                    (n1, n2), order="F")
                out[:, :, k] = pl[row0:row0 + nrows]
            return out
    mm = np.memmap(path, dtype=dtype, mode="r", offset=data_off,
                   shape=tuple(mesh), order="F")
    return np.ascontiguousarray(mm[row0:row0 + nrows])


def read_stream_cube_slab(path: str, mesh: Tuple[int, int, int],
                          dtype=np.float32, row0: int = 0,
                          nrows: Optional[int] = None,
                          header: bool = True) -> np.ndarray:
    """Slab read of a stream-access cube (see read_stream_cube)."""
    nrows = mesh[0] if nrows is None else nrows
    off = 12 if header else 0
    if header:
        with open(path, "rb") as f:
            m = np.fromfile(f, np.int32, 3)
            if tuple(m) != tuple(mesh):
                raise ValueError(f"{path}: mesh {tuple(m)} != {mesh}")
    mm = np.memmap(path, dtype=dtype, mode="r", offset=off,
                   shape=tuple(mesh), order="F")
    return np.ascontiguousarray(mm[row0:row0 + nrows])


def write_sm3d_stream(path: str, mesh: Tuple[int, int, int], dtype,
                      blocks) -> None:
    """Write an sm3d cube from a stream of z-blocks.

    `blocks` yields C-order (n1, n2, kc) arrays covering ascending z.
    In the file's Fortran order z is the SLOWEST axis, so each block is
    one contiguous span of the data record — peak memory is one block,
    never the cube (the write path of the halo layout's outputs)."""
    n1, n2, n3 = mesh
    itemsize = np.dtype(dtype).itemsize
    total = n1 * n2 * n3 * itemsize
    header = np.asarray(mesh, np.int32).tobytes()
    subs = _sub_lengths(total)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(header)))
        f.write(header)
        f.write(struct.pack("<i", len(header)))
        # data record, split into gfortran subrecords past 2 GiB; the
        # incoming z-blocks are emitted across subrecord boundaries
        si = 0
        remaining = subs[0]
        f.write(struct.pack("<i", subs[0] if len(subs) == 1 else -subs[0]))
        written = 0
        for b in blocks:
            chunk = np.asarray(b, dtype).tobytes(order="F")
            written += len(chunk)
            view = memoryview(chunk)
            while view:
                take = min(remaining, len(view))
                f.write(view[:take])
                view = view[take:]
                remaining -= take
                if remaining == 0 and si < len(subs) - 1:
                    f.write(struct.pack(
                        "<i", subs[si] if si == 0 else -subs[si]))
                    si += 1
                    remaining = subs[si]
                    f.write(struct.pack(
                        "<i", subs[si] if si == len(subs) - 1
                        else -subs[si]))
        if written != total:
            raise IOError(f"{path}: wrote {written} bytes, expected {total}")
        f.write(struct.pack("<i", subs[-1] if si == 0 else -subs[-1]))


def read_stream_cube(path: str, mesh: Tuple[int, int, int],
                     dtype=np.float32, header: bool = True) -> np.ndarray:
    """Read a stream-access (headerless-record) binary cube, optionally
    with a leading (m1,m2,m3) int32 header (densityformat="unformatted",
    densityaccess="stream" in the nbody adapters)."""
    with open(path, "rb") as f:
        if header:
            m = np.fromfile(f, np.int32, 3)
            if tuple(m) != tuple(mesh):
                raise ValueError(f"{path}: mesh {tuple(m)} != expected {mesh}")
        a = np.fromfile(f, dtype, int(np.prod(mesh)))
    return np.ascontiguousarray(a.reshape(mesh, order="F"))


def write_stream_cube(path: str, array: np.ndarray, dtype=np.float32,
                      header: bool = True) -> None:
    with open(path, "wb") as f:
        a = np.asarray(array)
        if header:
            np.asarray(a.shape, np.int32).tofile(f)
        a.astype(dtype).flatten(order="F").tofile(f)
