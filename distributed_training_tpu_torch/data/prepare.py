"""Corpus preparation: real text files → flat binary token shard (port
of ``data/prepare.py``: the same output bytes and the same sidecar).

The real-data layout the framework trains from is a flat binary file of
token ids on (shared) storage, windowed by ``MemmapTokenDataset``
(datasets.py) — the standard pretraining shard format. This tool builds
one from ANY local text:

- ``bytes`` mode (default): raw UTF-8 bytes, vocab 256, uint8 storage.
  Zero external dependencies — subword tokenizers need downloaded vocab
  files; bytes need nothing — which makes it the hermetic real-data
  path for tests/benches as well as a legitimate byte-LM recipe.
- ``tokens`` mode: pass-through for corpora you already tokenized
  elsewhere (any integer .npy), stored uint16/uint32 as the vocab
  requires.

A ``<out>.json`` sidecar records vocab/dtype/provenance so configs can
sanity-check what they're training on.

The reference has no data-prep tooling at all (its corpus is
``torch.rand``, src/data_utils.py:7-16); this exists because
BASELINE.json config 3 targets a real tokenized shard.

Usage:
    python -m distributed_training_tpu_torch.data.prepare \
        --out /data/corpus.bin 'src/**/*.py' docs/*.md
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import sys

import numpy as np


def collect_files(patterns: list[str]) -> list[str]:
    files: list[str] = []
    for pat in patterns:
        matches = sorted(glob.glob(pat, recursive=True))
        files.extend(m for m in matches if os.path.isfile(m))
    # de-dup, keep order
    seen: set[str] = set()
    out = []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


def prepare_bytes(out_path: str, inputs: list[str],
                  separator: bytes = b"\n\n") -> dict:
    """Concatenate files as raw bytes into ``out_path`` (uint8)."""
    files = collect_files(inputs)
    if not files:
        raise FileNotFoundError(f"no files matched {inputs}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    sha = hashlib.sha256()
    total = 0
    with open(out_path, "wb") as out:
        for i, f in enumerate(files):
            with open(f, "rb") as src:
                blob = src.read()
            if i:
                out.write(separator)
                sha.update(separator)
                total += len(separator)
            out.write(blob)
            sha.update(blob)
            total += len(blob)
    meta = {
        "mode": "bytes",
        "dtype": "uint8",
        "vocab_size": 256,
        "n_tokens": total,
        "n_files": len(files),
        "sha256": sha.hexdigest(),
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def prepare_tokens(out_path: str, inputs: list[str],
                   vocab_size: int) -> dict:
    """Concatenate pre-tokenized .npy arrays into a flat binary."""
    files = collect_files(inputs)
    if not files:
        raise FileNotFoundError(f"no files matched {inputs}")
    dtype = "uint16" if vocab_size <= 2 ** 16 else "uint32"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    total = 0
    with open(out_path, "wb") as out:
        for f in files:
            arr = np.load(f)
            if arr.min() < 0 or arr.max() >= vocab_size:
                raise ValueError(
                    f"{f}: token ids outside [0, {vocab_size})")
            blob = np.ascontiguousarray(arr.reshape(-1), dtype=dtype)
            out.write(blob.tobytes())
            total += blob.size
    meta = {
        "mode": "tokens",
        "dtype": dtype,
        "vocab_size": vocab_size,
        "n_tokens": total,
        "n_files": len(files),
    }
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("inputs", nargs="+",
                   help="files / glob patterns (recursive ** ok)")
    p.add_argument("--out", required=True, help="output .bin path")
    p.add_argument("--mode", choices=("bytes", "tokens"),
                   default="bytes")
    p.add_argument("--vocab-size", type=int, default=50257,
                   help="tokens mode: vocabulary bound for validation")
    args = p.parse_args(argv)
    if args.mode == "bytes":
        meta = prepare_bytes(args.out, args.inputs)
    else:
        meta = prepare_tokens(args.out, args.inputs, args.vocab_size)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    sys.exit(main())
