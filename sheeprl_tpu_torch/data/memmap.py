"""Disk-backed numpy arrays with ownership semantics.

An ndarray view over an OS memory-mapped file with explicit file ownership
(the owner deletes the file on ``__del__``), safe flush/close, and pickling
support that re-attaches to the file on restore (the receiving process never
owns the file).

This is how replay buffers exceed host RAM: the OS pages buffer slices in
on demand while sampling, and only the sampled minibatch is staged to the
device.  (A copy of ``sheeprl_tpu/data/memmap.py``, which imports no JAX;
the port keeps its own.)
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_ALLOWED_MODES = ("r+", "w+", "c", "copyonwrite", "readwrite", "write")


class MemmapArray:
    def __init__(
        self,
        shape: Tuple[int, ...],
        dtype: Any = np.float32,
        mode: str = "r+",
        filename: str | os.PathLike | None = None,
    ):
        if mode not in _ALLOWED_MODES:
            raise ValueError(f"Accepted values for mode are {_ALLOWED_MODES}, got '{mode}'")
        if filename is None:
            raise ValueError("A 'filename' must be provided for a MemmapArray")
        self._filename = Path(filename).resolve()
        self._filename.parent.mkdir(parents=True, exist_ok=True)
        self._shape = tuple(shape)
        self._dtype = np.dtype(dtype)
        self._mode = mode
        existed = self._filename.is_file()
        # np.memmap needs 'w+' to create; preserve content when attaching
        create_mode = mode if existed and mode != "w+" else "w+"
        self._array = np.memmap(self._filename, dtype=self._dtype, mode=create_mode, shape=self._shape)
        self._has_ownership = True

    # -- core ndarray-ish API ------------------------------------------------
    @property
    def array(self) -> np.memmap:
        if self._array is None:
            raise RuntimeError("The memmap has been closed")
        return self._array

    @array.setter
    def array(self, value: np.ndarray) -> None:
        if not isinstance(value, np.ndarray):
            raise ValueError("The value to set must be a numpy array")
        if value.shape != self._shape:
            raise ValueError(f"Shape mismatch: expected {self._shape}, got {value.shape}")
        self._array[:] = value

    @property
    def filename(self) -> str:
        return str(self._filename)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def nbytes(self) -> int:
        """Bytes of the backing file (shape x itemsize — what the buffer
        costs on disk; the OS pages it in and out of RAM on demand)."""
        size = self._dtype.itemsize
        for dim in self._shape:
            size *= int(dim)
        return size

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    def __getitem__(self, idx) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx, value) -> None:
        self.array[idx] = value

    def __array__(self, dtype=None) -> np.ndarray:
        arr = np.asarray(self.array)
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self) -> int:
        return self._shape[0]

    def flush(self) -> None:
        if self._array is not None:
            self._array.flush()

    def __del__(self) -> None:
        try:
            if getattr(self, "_array", None) is not None:
                self._array.flush()
                # release the mmap before (possibly) deleting the backing file
                del self._array
                self._array = None
            if getattr(self, "_has_ownership", False) and self._filename.is_file():
                self._filename.unlink()
        except Exception:
            pass

    # -- pickling: re-attach without taking ownership ------------------------
    def __getstate__(self) -> dict:
        self.flush()
        return {
            "_filename": self._filename,
            "_shape": self._shape,
            "_dtype": self._dtype,
            "_mode": self._mode,
        }

    def __setstate__(self, state: dict) -> None:
        self._filename = state["_filename"]
        self._shape = state["_shape"]
        self._dtype = state["_dtype"]
        self._mode = state["_mode"]
        self._array = np.memmap(self._filename, dtype=self._dtype, mode="r+", shape=self._shape)
        self._has_ownership = False

    @classmethod
    def from_array(
        cls, array: np.ndarray | "MemmapArray", filename: str | os.PathLike, mode: str = "r+"
    ) -> "MemmapArray":
        if isinstance(array, MemmapArray):
            array = array.array
        out = cls(shape=array.shape, dtype=array.dtype, mode=mode, filename=filename)
        out.array = np.asarray(array)
        return out

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, mode={self._mode}, filename={self._filename})"
