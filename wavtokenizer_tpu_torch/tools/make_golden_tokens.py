"""Write the golden configs' token ids, as this package computes them, to a file.

Port of ``tools_tpu/make_golden_tokens.py``: the codes of the seeded golden
clip for every config of ``utils/golden.py::golden_specs``, through
``WavTokenizer.encode_infer`` on ``--device``, into ``--out`` (npz, int32).
The committed ``tests/golden/bench_tokens.npz`` holds the JAX package's ids
from XLA:CPU and is refused as ``--out``: compare a file written here with
it (``utils/golden.py::check_codes``), never replace it with one.

    python -m wavtokenizer_tpu_torch.tools.make_golden_tokens --out codes.npz \\
        [--device cuda]
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True, help="npz file to write")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.golden import write_golden

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu for the plain versions on the CPU)")
        return 1
    print(f"wrote {write_golden(args.out, args.device)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
