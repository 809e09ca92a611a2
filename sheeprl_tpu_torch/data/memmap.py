"""Memory-mapped numpy array with file ownership + pickling.

The port's own copy of `MemmapArray` (`sheeprl_tpu/data/memmap.py`):
an np.memmap wrapper that (a) owns or borrows its backing file, (b) survives
pickling by re-opening the file in the child process (spawned workers share
the same storage), and (c) behaves like an ndarray for indexing/ufuncs.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

import numpy as np


class MemmapArray(np.lib.mixins.NDArrayOperatorsMixin):
    def __init__(
        self,
        shape: Sequence[int],
        dtype: Any = np.float32,
        mode: str = "r+",
        filename: Optional[os.PathLike] = None,
    ):
        self._shape = tuple(int(s) for s in shape)
        self._dtype = np.dtype(dtype)
        if filename is None:
            fd, fname = tempfile.mkstemp(suffix=".memmap")
            os.close(fd)
            self._filename = Path(fname)
            self._has_ownership = True
        else:
            self._filename = Path(filename)
            self._filename.parent.mkdir(parents=True, exist_ok=True)
            self._has_ownership = not self._filename.exists()
            self._filename.touch(exist_ok=True)
        self._mode = mode
        nbytes = int(np.prod(self._shape)) * self._dtype.itemsize
        if self._filename.stat().st_size < nbytes:
            with open(self._filename, "r+b") as f:
                f.truncate(nbytes)
        self._array: Optional[np.memmap] = np.memmap(
            self._filename, dtype=self._dtype, mode="r+", shape=self._shape
        )

    # -- ndarray protocol --------------------------------------------------
    @property
    def array(self) -> np.memmap:
        assert self._array is not None
        return self._array

    @array.setter
    def array(self, value: np.ndarray) -> None:
        if value.shape != self._shape:
            raise ValueError(f"Shape mismatch: {value.shape} vs {self._shape}")
        self._array[:] = value

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def filename(self) -> Path:
        return self._filename

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    def __getitem__(self, idx: Any) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx: Any, value: Any) -> None:
        self.array[idx] = value

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        out = np.asarray(self.array)
        return out.astype(dtype) if dtype is not None else out

    def __array_ufunc__(self, ufunc: Any, method: str, *inputs: Any, **kwargs: Any) -> Any:
        inputs = tuple(np.asarray(x) if isinstance(x, MemmapArray) else x for x in inputs)
        return getattr(ufunc, method)(*inputs, **kwargs)

    def __len__(self) -> int:
        return self._shape[0]

    def flush(self) -> None:
        """Push dirty pages to the backing file (durability point for the
        checkpoint memmap fast path)."""
        if self._array is not None:
            self._array.flush()

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, file={self._filename})"

    # -- pickling: re-open the same file, never own it in the child --------
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_array"] = None
        state["_has_ownership"] = False
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._array = np.memmap(self._filename, dtype=self._dtype, mode="r+", shape=self._shape)

    @classmethod
    def from_array(
        cls, array: np.ndarray, filename: Optional[os.PathLike] = None
    ) -> "MemmapArray":
        out = cls(array.shape, array.dtype, filename=filename)
        out.array = np.asarray(array)
        return out

    def __del__(self) -> None:
        try:
            if self._has_ownership and self._array is not None:
                del self._array
                self._array = None
                if self._filename.exists():
                    os.unlink(self._filename)
        except Exception:
            pass
