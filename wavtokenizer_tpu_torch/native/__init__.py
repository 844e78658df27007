"""The C++ training-data loader, bound with ctypes.

Port of ``wavtokenizer_tpu/native/__init__.py``.  ``wt_data_loader.cc`` is a
byte-for-byte copy of the JAX package's source: WAV decode, mono mix, sox-style
peak normalization, polyphase sinc resampling, crop or repeat-pad, and batches
prefetched by a pool of threads, each batch a pure function of (seed, batch
index), so the thread count never changes what it yields.  The library is
built with ``g++`` at first use into ``wavtokenizer_tpu_torch/_build/`` (listed
in ``.gitignore``), named by the hash of the source; nothing is written next to
the source.  Where ``g++`` is missing or fails, ``available()`` is False and the
trainer runs the Python loader of ``train/data.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "wt_data_loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """The library built from the source's present content."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libwtdata_{digest}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path.  Written to
    a file of this process first and renamed, so processes that build it at
    once never load a half-written library."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                              SOURCE, "-o", tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build the data loader:\n{res.stderr}")
        os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The library's ctypes handle, built if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.wtl_create.restype = ctypes.c_void_p
            lib.wtl_create.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong,
                ctypes.c_longlong]
            lib.wtl_next.restype = ctypes.c_int
            lib.wtl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
            lib.wtl_errors.restype = ctypes.c_long
            lib.wtl_errors.argtypes = [ctypes.c_void_p]
            lib.wtl_num_files.restype = ctypes.c_long
            lib.wtl_num_files.argtypes = [ctypes.c_void_p]
            lib.wtl_destroy.restype = None
            lib.wtl_destroy.argtypes = [ctypes.c_void_p]
            lib.wtl_read_wav.restype = ctypes.c_int
            lib.wtl_read_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                         ctypes.POINTER(ctypes.c_long),
                                         ctypes.POINTER(ctypes.c_int)]
            lib.wtl_resample.restype = ctypes.c_long
            lib.wtl_resample.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_library()
        return True
    except (OSError, RuntimeError):
        return False


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_wav_mono(path: str) -> tuple[np.ndarray, int]:
    """A WAV file decoded by the native parser: (mono float32 samples, rate)."""
    lib = load_library()
    n, sr = ctypes.c_long(), ctypes.c_int()
    if lib.wtl_read_wav(path.encode(), None, ctypes.byref(n), ctypes.byref(sr)):
        raise IOError(f"cannot decode {path}")
    out = np.empty(n.value, dtype=np.float32)
    if lib.wtl_read_wav(path.encode(), _float_ptr(out), ctypes.byref(n), ctypes.byref(sr)):
        raise IOError(f"cannot decode {path}")
    return out, sr.value


def resample_native(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sinc resampling in C++ (the filter of ``utils/audio.py::
    resample_np``)."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n_out = lib.wtl_resample(_float_ptr(x), len(x), orig_sr, new_sr, None)
    out = np.empty(n_out, dtype=np.float32)
    lib.wtl_resample(_float_ptr(x), len(x), orig_sr, new_sr, _float_ptr(out))
    return out


class NativeDataLoader:
    """The threaded native loader: (batch_size, num_samples) float32 batches,
    forever (epochs chained, reshuffled each epoch), the same for a seed
    whatever ``num_threads``.  ``start_seq`` starts the stream at global batch
    index N without decoding the batches before it (a resumed run reads the
    batch the interrupted run would have read next).  With ``drop_last``
    False the last batch of an epoch is repeat-padded to the batch size."""

    def __init__(self, filelist: list[str], sample_rate: int = 24000,
                 num_samples: int = 72000, batch_size: int = 40, train: bool = True,
                 shuffle: bool | None = None, drop_last: bool = True, num_threads: int = 4,
                 queue_cap: int = 4, seed: int = 0, start_seq: int = 0):
        self._lib = load_library()
        self._h = self._lib.wtl_create(
            "\n".join(filelist).encode(), sample_rate, num_samples, batch_size, int(train),
            int(train if shuffle is None else shuffle), int(drop_last), num_threads,
            queue_cap, seed, start_seq)
        if not self._h:
            raise ValueError("empty file list or bad batch size")
        self.batch_size = batch_size
        self.num_samples = num_samples

    def next_batch(self) -> np.ndarray:
        out = np.empty((self.batch_size, self.num_samples), dtype=np.float32)
        if self._lib.wtl_next(self._h, _float_ptr(out)):
            raise StopIteration
        return out

    @property
    def errors(self) -> int:
        """Files that failed to decode so far (their rows are silence)."""
        return self._lib.wtl_errors(self._h)

    def __iter__(self):
        while True:
            yield self.next_batch()

    def close(self) -> None:
        """Stop the worker threads and free the loader."""
        if getattr(self, "_h", None):
            self._lib.wtl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
