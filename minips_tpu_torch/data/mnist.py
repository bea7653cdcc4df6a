"""MNIST idx-format reader — a copy of ``minips_tpu/data/mnist.py``, the
real-file path for the MLP workload.

The reference's MLP example trains on actual MNIST (BASELINE.json:8); the
dataset ships as the classic idx files (`train-images-idx3-ubyte`,
`train-labels-idx1-ubyte`, optionally .gz). This is the standard big-endian
idx codec: magic ``0x00 0x00 <dtype> <ndim>`` then ndim big-endian uint32
dims, then row-major payload. Pixels normalize to [0, 1] float32 and
flatten to [N, 784], matching ``models/mlp.py``'s input contract and the
synthetic `mnist_like` batch shape.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Decode one idx file (optionally gzipped) into an ndarray. Raises
    ValueError (with the path) on any malformed/truncated input."""
    with _open(path) as f:
        head = f.read(4)
        if len(head) != 4:
            raise ValueError(f"{path}: truncated idx header")
        zero, dtype_code, ndim = struct.unpack(">HBB", head)
        if zero != 0:
            raise ValueError(f"{path}: bad idx magic (leading {zero:#x})")
        dtype = _DTYPES.get(dtype_code)
        if dtype is None:
            raise ValueError(f"{path}: unknown idx dtype {dtype_code:#x}")
        raw_dims = f.read(4 * ndim)
        if len(raw_dims) != 4 * ndim:
            raise ValueError(f"{path}: truncated idx dims")
        dims = struct.unpack(">" + "I" * ndim, raw_dims)
        payload = f.read()
    want = int(np.prod(dims)) * np.dtype(dtype).itemsize
    if len(payload) < want:
        raise ValueError(f"{path}: truncated idx payload "
                         f"({len(payload)} < {want} bytes)")
    arr = np.frombuffer(payload[:want], dtype=np.dtype(dtype).newbyteorder(">"))
    return arr.reshape(dims).astype(dtype)


def write_idx(path: str, arr: np.ndarray) -> None:
    """Encode ``arr`` as an idx file (the test/synthetic-data writer)."""
    code = {v: k for k, v in _DTYPES.items()}[np.dtype(arr.dtype).type]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(np.ascontiguousarray(arr,
                                     np.dtype(arr.dtype).newbyteorder(">"))
                .tobytes())


def read_mnist(images_path: str, labels_path: str) -> dict:
    """(images idx3, labels idx1) → {"x": [N, 784] float32 in [0,1],
    "y": [N] int32} — the mlp_example batch dict."""
    images = read_idx(images_path)
    labels = read_idx(labels_path)
    if images.ndim != 3:
        raise ValueError(f"images file has ndim={images.ndim}, expected 3")
    if labels.ndim != 1 or labels.shape[0] != images.shape[0]:
        raise ValueError(
            f"labels shape {labels.shape} does not match "
            f"{images.shape[0]} images")
    x = images.reshape(images.shape[0], -1).astype(np.float32)
    if images.dtype == np.uint8:
        x /= 255.0  # uint8 pixels -> [0, 1]; float files are kept as-is
    elif np.issubdtype(images.dtype, np.integer):
        raise ValueError(
            f"images dtype {images.dtype} has no defined [0,1] scaling; "
            "MNIST images are uint8 (or pre-scaled floats)")
    return {"x": x, "y": labels.astype(np.int32)}
