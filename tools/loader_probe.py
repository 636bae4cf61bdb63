#!/usr/bin/env python3
"""The port's data loader on the host: its walls at chr21 scale, and its
contact reader against ``pandas.read_table`` by the format of the values.

    python3 tools/loader_probe.py [--n-values 500000] [--seed 0]

1. Writes the chr21 input with ``synth.write_example`` (657 bins, 4
   species, K=10, seed 0) into a temporary directory and times the
   quantile scan (``quantile_contact_vec``) and ``load_dataset`` as the
   command line runs them. Prints ``[loader]`` with the seconds.
2. Writes ``--n-values`` random positive values as 3-column contact files
   in three formats (``repr``: 17 significant digits; ``%.4f``; ``%.6g``),
   reads each with ``pandas.read_table`` (when pandas is installed) and
   with the port's ``load_contact_list``, and prints ``[reader]``: per
   format, the values parsed differently, the largest difference in
   float64 ulps, and the values whose ``float32(log1p(x))`` differs. On
   the command line the samples go through ``log1p`` and a float32 cast.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def loader_walls() -> dict:
    from phylo_hmrf_tpu_torch.cli import _resolve_paths
    from phylo_hmrf_tpu_torch.config import PhyloHMRFConfig
    from phylo_hmrf_tpu_torch.data.contacts import (quantile_contact_vec,
                                                    x_max_from_quantiles)
    from phylo_hmrf_tpu_torch.data.pipeline import load_dataset
    from phylo_hmrf_tpu_torch.synth import CHR21_H0, SPECIES, write_example

    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "input")
        t0 = time.perf_counter()
        write_example(data, n_bins=CHR21_H0 + 4, n_states=10, chroms=(21,))
        write_s = time.perf_counter() - t0
        cfg = PhyloHMRFConfig(n_states=10)
        sizes = os.path.join(data, "hg38.chrom.sizes")
        paths = _resolve_paths(data)
        t0 = time.perf_counter()
        m_vec = quantile_contact_vec([21], cfg.resolution, sizes, paths,
                                     SPECIES)
        x_max = x_max_from_quantiles(m_vec)
        quantile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        regions, _ = load_dataset([21], cfg, sizes, paths, SPECIES, data,
                                  x_max)
        load_s = time.perf_counter() - t0
    return dict(write_input_s=write_s, quantile_s=quantile_s, load_s=load_s,
                regions=[(r.H0, r.W0, r.n_samples) for r in regions])


def reader_vs_pandas(n: int, seed: int) -> dict:
    try:
        import pandas as pd
    except ImportError:
        return {"pandas": None}
    from phylo_hmrf_tpu_torch.data.contacts import load_contact_list

    rng = np.random.default_rng(seed)
    values = rng.random(n) * rng.choice([1e-2, 1.0, 80.0, 4e4], n)
    out = {"pandas": pd.__version__, "n_values": n}
    with tempfile.TemporaryDirectory() as d:
        for name, fmt in (("repr", repr), ("%.4f", lambda v: f"{v:.4f}"),
                          ("%.6g", lambda v: f"{v:.6g}")):
            path = os.path.join(d, "chr1.50K.txt")
            with open(path, "w") as f:
                f.write("".join(f"0\t0\t{fmt(float(v))}\n" for v in values))
            a = np.asarray(pd.read_table(path, header=None)[2], np.float64)
            b = load_contact_list(path)[2]
            ulps = np.abs(a.view(np.int64) - b.view(np.int64))
            f32 = (np.log1p(a).astype(np.float32)
                   != np.log1p(b).astype(np.float32))
            out[name] = dict(differ=int((a != b).sum()),
                             max_ulps=int(ulps.max()),
                             float32_log1p_differ=int(f32.sum()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-values", type=int, default=500000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(f"[loader] {json.dumps(loader_walls())}")
    print(f"[reader] {json.dumps(reader_vs_pandas(args.n_values, args.seed))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
