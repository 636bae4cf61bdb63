"""Reconstruct the reference's canonical example input when contact files
are missing from the mirror — the port's copy of
``phylo_hmrf_tpu/data/reconstruct.py``.

The reference README's canonical run (its `README.md:51`) is

    python phylo_hmrf.py -n 20 -r 1 --reload 0 --chromvec 21,22 --miter 100

over 4 species (gorGor4, panTro5, panPan2, hg38), but the mirror strips
four of the eight contact files (its `.MISSING_LARGE_BLOBS`: hg38
chr21+chr22, gorGor4 chr21, panTro5 chr21). This script builds a
complete input directory by copying every present file verbatim and
synthesizing each missing `chrN.50K.txt` deterministically from a present
donor species on the same chromosome (per-species scale + smooth lognormal
perturbation + light dropout), preserving the reference 3-column
`pos1\tpos2\tvalue` format, bin positions and sparsity structure. The
result exercises the full canonical path (4 species, chr21+22 joint,
union alignment incl. pairs missing in some species); it is a
reconstruction for pipeline validation, not real hg38/chr21 Hi-C.

    python -m phylo_hmrf_tpu_torch.data.reconstruct \
        --reference REFERENCE/example_input --out canonical_input

Two differences from the JAX package's copy. Each synthesized file's
generator is seeded with ``zlib.crc32`` of ``"species:chrom"``
(`synth_seed`): the JAX copy seeds it with Python's ``hash`` of the pair,
which is salted per process for strings, so its output changed from run
to run. And ``--reference`` has no default: it names the reference's
``example_input`` directory wherever it is.
"""

import argparse
import os
import shutil
import sys
import zlib

import numpy as np

SPECIES = ["gorGor4", "panTro5", "panPan2", "hg38"]
CHROMS = [21, 22]
# deterministic per-(species, chrom) synthesis parameters
SCALES = {"hg38": 1.12, "gorGor4": 0.94, "panTro5": 1.05}
DONOR = "panPan2"   # the one species with both chromosomes present


def synth_seed(species: str, chrom: int) -> int:
    """The generator seed of one synthesized file, the same in every
    process."""
    return zlib.crc32(f"{species}:{chrom}".encode()) % (2 ** 31)


def synth_from_donor(donor_file: str, species: str, chrom: int,
                     out_file: str) -> None:
    rng = np.random.default_rng(synth_seed(species, chrom))
    data = np.loadtxt(donor_file)
    pos = data[:, :2].astype(np.int64)
    val = data[:, 2].astype(np.float64)
    scale = SCALES[species]
    # smooth multiplicative field: lognormal noise correlated along the
    # diagonal offset, so the perturbation looks like a biological rescale
    # rather than white noise
    offs = ((pos[:, 1] - pos[:, 0]) // 50000).astype(np.int64)
    n_off = int(offs.max()) + 1
    band = np.exp(rng.normal(0.0, 0.25, n_off))
    noise = np.exp(rng.normal(0.0, 0.15, val.shape[0]))
    new_val = val * scale * band[offs] * noise
    keep = rng.random(val.shape[0]) >= 0.05   # 5% dropout: union-align work
    with open(out_file, "w") as f:
        for (p1, p2), v in zip(pos[keep], new_val[keep]):
            f.write(f"{p1}\t{p2}\t{v:.4f}\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="canonical_input")
    ap.add_argument("--reference", required=True,
                    help="the reference's example_input directory")
    args = ap.parse_args(argv)
    ref = args.reference
    out = args.out
    os.makedirs(out, exist_ok=True)

    for name in ["edge.1.txt", "branch_length.1.txt", "species_name.1.txt",
                 "hg38.chrom.sizes"] + [f"chr{c}.synteny.txt"
                                        for c in CHROMS]:
        shutil.copy(os.path.join(ref, name), os.path.join(out, name))
    # reference convention: entries relative to the data dir's parent
    # (README.md:51 runs from the repo root with -p example_input)
    base = os.path.basename(os.path.abspath(out))
    with open(os.path.join(out, "path_list.txt"), "w") as f:
        for s in SPECIES:
            f.write(f"{base}/test_data/hic_{s}\n")

    n_synth = 0
    for s in SPECIES:
        d = os.path.join(out, "test_data", f"hic_{s}")
        os.makedirs(d, exist_ok=True)
        for c in CHROMS:
            src = os.path.join(ref, "test_data", f"hic_{s}",
                               f"chr{c}.50K.txt")
            dst = os.path.join(d, f"chr{c}.50K.txt")
            if os.path.exists(src):
                shutil.copy(src, dst)
            else:
                donor = os.path.join(ref, "test_data", f"hic_{DONOR}",
                                     f"chr{c}.50K.txt")
                synth_from_donor(donor, s, c, dst)
                n_synth += 1
    print(f"reconstructed {out}: {n_synth} synthesized contact files, "
          f"{len(SPECIES) * len(CHROMS) - n_synth} real")


if __name__ == "__main__":
    sys.exit(main())
