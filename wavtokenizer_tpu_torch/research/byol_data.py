"""BYOL pair datasets: Kaldi x-vectors and saved-feature views.

The port's own numpy copy of ``wavtokenizer_tpu/research/byol_data.py``
(ref byol_dataset.py):

* ``XVectorPairs`` = XVectorDataset (byol_dataset.py:8-110): load an
  ``xvector.scp``, group keys like ``boy1_box_LDV_001`` by speaker and
  material, then pair (a) each material utterance with its ``<mat>_clean``
  counterpart sharing the trailing utterance number and (b) same-numbered
  utterances across later materials (no duplicate unordered pairs).
* ``feature_pair_views`` = WavFeatureDataset (byol_dataset.py:136-152):
  two views of saved features by adding N(0, 0.01) noise.

The reference reads x-vectors through ``kaldiio``; ``read_kaldi_scp`` is a
minimal reader of Kaldi's binary ark format (``\\0B`` marker + "FV "/"FM "
float vector / matrix records, what kaldiio writes by default), with the
matching writer.  Values round-trip bit-exactly (f32).
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np


# ---------------------------------------------------------------- kaldi io

def _read_basic_int(f) -> int:
    """Kaldi binary int: a size byte (always 4) then little-endian int32."""
    size = f.read(1)[0]
    if size != 4:
        raise ValueError(f"unsupported kaldi int size {size}")
    return struct.unpack("<i", f.read(4))[0]


def read_kaldi_ark_at(path: str, offset: int) -> np.ndarray:
    """Read one binary float vector/matrix record at ``path:offset``."""
    with open(path, "rb") as f:
        f.seek(offset)
        if f.read(2) != b"\0B":
            raise ValueError(f"{path}:{offset}: not a kaldi binary record")
        token = b""
        while not token.endswith(b" "):
            b = f.read(1)
            if not b:
                raise ValueError(f"{path}:{offset}: truncated kaldi record")
            token += b
        kind = token.decode().strip()
        dtype = {"FV": "<f4", "FM": "<f4",
                 "DV": "<f8", "DM": "<f8"}.get(kind)
        if dtype is None:
            raise ValueError(f"unsupported kaldi record type {kind!r}")
        if kind.endswith("V"):
            dim = _read_basic_int(f)
            return np.frombuffer(f.read(dim * int(dtype[-1])), dtype).copy()
        rows = _read_basic_int(f)
        cols = _read_basic_int(f)
        n = rows * cols * int(dtype[-1])
        return np.frombuffer(f.read(n), dtype).reshape(rows, cols).copy()


def read_kaldi_scp(scp_path: str) -> dict[str, np.ndarray]:
    """``utt ark_path:offset`` lines -> {utt: ndarray} (eager load; x-vector
    sets are small).  Relative ark paths resolve against the scp's dir."""
    base = os.path.dirname(os.path.abspath(scp_path))
    out: dict[str, np.ndarray] = {}
    with open(scp_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt, rx = line.split(None, 1)
            path, _, offset = rx.rpartition(":")
            if not os.path.isabs(path):
                path = os.path.join(base, path)
            out[utt] = read_kaldi_ark_at(path, int(offset))
    return out


def write_kaldi_ark_scp(ark_path: str, scp_path: str,
                        data: dict[str, np.ndarray]) -> None:
    """Write float32 vectors/matrices in Kaldi binary ark + scp form
    (the format ``read_kaldi_scp`` consumes; used by tests and exporters)."""
    with open(ark_path, "wb") as ark, open(scp_path, "w") as scp:
        for utt, arr in data.items():
            arr = np.asarray(arr, "<f4")
            ark.write(utt.encode() + b" ")
            offset = ark.tell()
            kind = b"FV " if arr.ndim == 1 else b"FM "
            ark.write(b"\0B" + kind)
            for d in ([len(arr)] if arr.ndim == 1 else arr.shape):
                ark.write(b"\x04" + struct.pack("<i", d))
            ark.write(arr.tobytes())
            scp.write(f"{utt} {os.path.abspath(ark_path)}:{offset}\n")


# ---------------------------------------------------------------- pairing

DEFAULT_MATERIALS = ("box", "papercup", "plastic")


def group_by_speaker_material(keys, detect_clean: bool = False
                              ) -> dict[str, dict[str, list[str]]]:
    """'boy1_box_LDV_001' -> {spk: {material: [keys]}}
    (ref byol_dataset.py:29-49; keys with <3 parts are skipped).

    ``detect_clean=False`` mirrors the reference exactly: material is
    always ``parts[1]``, which means a ``<mat>_clean`` material group can
    never form from '_'-split keys — the clean-pairing phase of
    ``make_pairs`` is inert (latent reference quirk, byol_dataset.py:40,68).
    ``detect_clean=True`` is the documented fix: a literal ``clean`` third
    token ('boy1_box_clean_001') groups as material ``box_clean`` so the
    intended clean pairing happens."""
    grouped: dict[str, dict[str, list[str]]] = {}
    for key in keys:
        parts = key.split("_")
        if len(parts) < 3:
            continue
        spk, material = parts[0], parts[1]
        if detect_clean and len(parts) > 3 and parts[2] == "clean":
            material += "_clean"
        grouped.setdefault(spk, {}).setdefault(material, []).append(key)
    return grouped


def make_pairs(keys, materials=DEFAULT_MATERIALS,
               detect_clean: bool = False) -> list[tuple[str, str]]:
    """The reference's two-phase pairing (byol_dataset.py:51-90):
    material<->material_clean by trailing utt number, then cross-material
    (later materials only) by utt number.  See ``group_by_speaker_material``
    for the ``detect_clean`` quirk/fix switch.

    Matching mirrors the reference's ``endswith(utt_num)``
    (byol_dataset.py:68,86), which over-matches suffixes on datasets with
    >999 utterances ('1001'.endswith('001')); kept for parity — with the
    fork's zero-padded 3-digit numbering it is exact."""
    grouped = group_by_speaker_material(keys, detect_clean)
    pairs: list[tuple[str, str]] = []
    for spk in grouped:
        for mat in materials:
            if mat not in grouped[spk]:
                continue
            for utt1 in grouped[spk][mat]:
                m = re.search(r"(\d+)$", utt1)
                if not m:
                    continue
                utt_num = m.group(1)
                clean = [u for u in grouped[spk].get(mat + "_clean", [])
                         if u.endswith(utt_num)]
                if clean:
                    pairs.append((utt1, clean[0]))
        for i, mat1 in enumerate(materials):
            if mat1 not in grouped[spk]:
                continue
            for utt1 in grouped[spk][mat1]:
                m = re.search(r"(\d+)$", utt1)
                if not m:
                    continue
                utt_num = m.group(1)
                for mat2 in materials[i + 1:]:
                    if mat2 not in grouped[spk]:
                        continue
                    cands = [u for u in grouped[spk][mat2]
                             if u.endswith(utt_num)]
                    if cands:
                        pairs.append((utt1, cands[0]))
    return pairs


class XVectorPairs:
    """X-vector pair sampler for BYOL (ref XVectorDataset)."""

    def __init__(self, scp_path: str, materials=DEFAULT_MATERIALS,
                 detect_clean: bool = False):
        self.vectors = read_kaldi_scp(scp_path)
        self.pairs = make_pairs(self.vectors.keys(), materials, detect_clean)
        if not self.pairs:
            raise ValueError(f"no pairable utterances in {scp_path}")

    @property
    def feat_dim(self) -> int:
        return next(iter(self.vectors.values())).shape[-1]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int):
        """-> (x1, x2, speaker_label, utt_id) like the torch dataset."""
        utt1, utt2 = self.pairs[idx]
        return (np.asarray(self.vectors[utt1], np.float32),
                np.asarray(self.vectors[utt2], np.float32),
                utt1.split("_")[0], utt1)

    def batch(self, rng: np.random.Generator, batch_size: int):
        """Sample a training batch -> (x1 (B, D), x2 (B, D), labels)."""
        idx = rng.integers(0, len(self.pairs), size=batch_size)
        items = [self[i] for i in idx]
        return (np.stack([a for a, _, _, _ in items]),
                np.stack([b for _, b, _, _ in items]),
                [l for _, _, l, _ in items])


def feature_pair_views(features: np.ndarray, rng: np.random.Generator,
                       noise_scale: float = 0.01):
    """Two noise-perturbed views of saved features
    (ref WavFeatureDataset, byol_dataset.py:144-146)."""
    f = np.asarray(features, np.float32)
    return (f + rng.normal(size=f.shape).astype(np.float32) * noise_scale,
            f + rng.normal(size=f.shape).astype(np.float32) * noise_scale)
