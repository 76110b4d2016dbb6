"""Minimal NIfTI-1 writer (replaces the reference's SimpleITK .nii.gz export,
``utils_synapse.py:88-97``) with the same (1, 1, z_spacing) spacing convention.

A copy of ``cenet_tpu/evaluate/nifti.py`` (the port imports nothing of the JAX
package). Pure numpy + gzip: a 348-byte header + extension flag + raw data.
Readable by nibabel/ITK/FSL. The one change: ``.nii.gz`` is written at gzip
level 1, not 9. The decompressed bytes are the same, and a 64 × 512² fp32 CT
then compresses in about 2 s, not 96 s, at 0.48 of its size, not about 0.41.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPE_CODES = {
    np.dtype(np.uint8): 2,
    np.dtype(np.int16): 4,
    np.dtype(np.int32): 8,
    np.dtype(np.float32): 16,
    np.dtype(np.float64): 64,
}


def write_nifti(path: str, volume: np.ndarray, spacing=(1.0, 1.0, 1.0)):
    """Write a 3-D volume (z, y, x order, like the reference's sitk arrays) to
    .nii or .nii.gz with voxel spacing (x, y, z)."""
    vol = np.asarray(volume)
    if vol.dtype not in _DTYPE_CODES:
        vol = vol.astype(np.float32)
    # NIfTI stores x fastest; our array is (z, y, x) C-order → data already in
    # x-fastest order when flattened; dims are (x, y, z).
    nz, ny, nx = vol.shape
    code = _DTYPE_CODES[vol.dtype]
    bitpix = vol.dtype.itemsize * 8

    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)  # sizeof_hdr
    struct.pack_into("<8h", header, 40, 3, nx, ny, nz, 1, 1, 1, 1)  # dim
    struct.pack_into("<h", header, 70, code)  # datatype
    struct.pack_into("<h", header, 72, bitpix)
    sx, sy, sz = spacing
    struct.pack_into("<8f", header, 76, 0.0, sx, sy, sz, 0.0, 0.0, 0.0, 0.0)  # pixdim
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    struct.pack_into("<h", header, 252, 1)  # qform_code
    struct.pack_into("<f", header, 268, 1.0)  # quatern (identity-ish)
    struct.pack_into("<4s", header, 344, b"n+1\x00")  # magic

    payload = bytes(header) + b"\x00" * 4 + vol.tobytes()
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def read_nifti(path: str) -> np.ndarray:
    """Read back volumes written by ``write_nifti`` (round-trip/testing aid)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    dim = struct.unpack_from("<8h", data, 40)
    code = struct.unpack_from("<h", data, 70)[0]
    offset = int(struct.unpack_from("<f", data, 108)[0])
    dtype = {v: k for k, v in _DTYPE_CODES.items()}[code]
    nx, ny, nz = dim[1], dim[2], dim[3]
    arr = np.frombuffer(data[offset:], dtype=dtype, count=nx * ny * nz)
    return arr.reshape(nz, ny, nx)
