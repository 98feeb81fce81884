"""The split and transition files of the disent-family datasets, and
CelebA's transition file.

    python -m ctvae_torch.data.variations <dataset_name> [data_root]
        [--factor-sizes 4,4,4,8,4,15]
    python -m ctvae_torch.data.variations celeba [data_root]

The port's copy of the JAX package's generator
(``scripts/disent_variation_gen.py``), writing the same bytes:

* ``<data_root>/<name>/list_eval_partition.txt``: CSV ``,Id,Split``, a
  70 / 15 / 15 train / valid / test split seeded 42;
* ``<data_root>/<name>/variation_attrs_<F>.txt``: CSV
  ``,Inputs,Outputs,Variations,Sources,Targets,Splits``: for every factor
  f and every pair of adjacent values (v, v + 1), up to 1000 random
  factor combinations whose two ends fall in one split, both directions.

``factor_sizes`` replaces the dataset's grid (a stand-in rendered on a
smaller grid gets files that index it).

``generate_celeba`` is the port's copy of ``scripts/celeba_variation_gen.py``
(the same bytes): from ``celeba/list_attr_celeba.txt`` and
``list_eval_partition.txt``, ``celeba/variation_attrs_10.txt`` keyed by
file name: images grouped by their first 10 attributes with one left
out, up to 8 of each side of the left-out one drawn (``random.Random``
seeded 0) and paired within a split, both directions.
"""

from __future__ import annotations

import argparse
import csv
import os
import random
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from .disent_data import FACTOR_SIZES

MAX_INSTANCES_PER_VARIATION = 1000
CELEBA_VARIATIONS = 10
CELEBA_INSTANCES_PER_VARIATION = 8


def pos_to_idx(pos, sizes) -> int:
    idx = 0
    for p, s in zip(pos, sizes):
        idx = idx * s + p
    return idx


def generate(dataset_name: str, data_root: str = "Data/", seed: int = 42,
             factor_sizes: Optional[Sequence[int]] = None) -> str:
    """Write the two files of ``dataset_name`` under ``data_root``;
    returns the variation file's path."""
    sizes = tuple(factor_sizes or FACTOR_SIZES[dataset_name])
    data_len = int(np.prod(sizes))
    folder = os.path.join(data_root, dataset_name)
    os.makedirs(folder, exist_ok=True)

    # the split (70 / 15 / 15, the reference's random_split with seed 42)
    rng = np.random.default_rng(seed)
    n_valid = int(round(data_len * 0.15))
    n_test = int(round(data_len * 0.15))
    perm = rng.permutation(data_len)
    split_list = np.zeros(data_len, np.int64)
    split_list[perm[:n_valid]] = 1
    split_list[perm[n_valid:n_valid + n_test]] = 2
    with open(os.path.join(folder, "list_eval_partition.txt"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "Id", "Split"])
        for i in range(data_len):
            w.writerow([i, i, int(split_list[i])])

    # the transition pairs
    py_rng = random.Random(seed)
    rows = []
    uniques = set()
    for fct in range(len(sizes)):
        for v in range(sizes[fct] - 1):
            for _ in range(MAX_INSTANCES_PER_VARIATION):
                sample = [py_rng.randrange(s) for s in sizes]
                pos_s, pos_t = sample.copy(), sample.copy()
                pos_s[fct], pos_t[fct] = v, v + 1
                inp = pos_to_idx(pos_s, sizes)
                out = pos_to_idx(pos_t, sizes)
                if split_list[inp] != split_list[out] or \
                        (inp, out) in uniques:
                    continue
                spl = int(split_list[inp])
                rows.append((inp, out, fct, v, v + 1, spl))
                rows.append((out, inp, fct, v + 1, v, spl))
                uniques.add((inp, out))
                uniques.add((out, inp))
    out_path = os.path.join(folder, f"variation_attrs_{len(sizes)}.txt")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "Inputs", "Outputs", "Variations", "Sources",
                    "Targets", "Splits"])
        for i, r in enumerate(rows):
            w.writerow([i, *r])
    return out_path


def generate_celeba(data_root: str = "Data/") -> str:
    """Write ``<data_root>/celeba/variation_attrs_10.txt``; returns its
    path."""
    folder = os.path.join(data_root, "celeba")
    with open(os.path.join(folder, "list_attr_celeba.txt")) as f:
        _, _labels, *lines = f.readlines()
    hashes = {}
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        img_name, *attrs = parts
        attrs = [int(a) for a in attrs][:CELEBA_VARIATIONS]
        for variation in range(len(attrs)):
            key_attrs = list(attrs)
            key_attrs[variation] = "?"
            entry = hashes.setdefault((variation, tuple(key_attrs)),
                                      {"neg": [], "pos": []})
            entry["pos" if attrs[variation] == 1 else "neg"].append(img_name)
    img_splits = {}
    with open(os.path.join(folder, "list_eval_partition.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                img_splits[parts[0]] = int(parts[1])

    rng = random.Random(0)
    k = CELEBA_INSTANCES_PER_VARIATION
    rows, uniques = [], set()
    for (variation, _), h in hashes.items():
        negs = rng.choices(h["neg"], k=min(k, len(h["neg"]))) \
            if h["neg"] else []
        poss = rng.choices(h["pos"], k=min(k, len(h["pos"]))) \
            if h["pos"] else []
        for img_neg in negs:
            for img_pos in poss:
                if img_splits.get(img_pos) != img_splits.get(img_neg) or \
                        (img_neg, img_pos) in uniques:
                    continue
                spl = img_splits[img_pos]
                rows.append((img_neg, img_pos, variation, 0, 1, spl))
                rows.append((img_pos, img_neg, variation, 1, 0, spl))
                uniques.add((img_neg, img_pos))
                uniques.add((img_pos, img_neg))
    out_path = os.path.join(folder,
                            f"variation_attrs_{CELEBA_VARIATIONS}.txt")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "Inputs", "Outputs", "Variations", "Sources",
                    "Targets", "Splits"])
        for i, r in enumerate(rows):
            w.writerow([i, *r])
    print(f"{len(rows)} transitions ({Counter(r[2] for r in rows)}) -> "
          f"{out_path}")
    return out_path


def parse_sizes(text: Optional[str]):
    return tuple(int(v) for v in text.split(",")) if text else None


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dataset_name",
                        choices=sorted(FACTOR_SIZES) + ["celeba"])
    parser.add_argument("data_root", nargs="?", default="Data/")
    parser.add_argument("--factor-sizes", default=None,
                        help="comma-separated grid replacing the dataset's")
    args = parser.parse_args(argv)
    if args.dataset_name == "celeba":
        generate_celeba(args.data_root)
        return
    path = generate(args.dataset_name, args.data_root,
                    factor_sizes=parse_sizes(args.factor_sizes))
    print(f"=> {path}")


if __name__ == "__main__":
    main()
