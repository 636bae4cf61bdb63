"""Offline analysis / BED helpers (reference utility.py:49-265) — the
port's copy of ``phylo_hmrf_tpu/utils/bedio.py``, without pandas.

Ports: region intersection, BED export, per-chromosome state enrichment
(the reference's `state_enrichment` has unbound locals — utility.py:152-179;
the intended semantics are implemented here), and the inferCARs-style
synteny-alignment block parser used to prepare `chr*.synteny.txt` inputs.

The JAX package reads its tab-separated tables with
``pandas.read_table(header=None)`` and writes them with
``DataFrame.to_csv(header=False, index=False, sep="\\t")``; the GPU machine
has no pandas. `read_table` and `write_table` do the same with the
``csv`` module: a column is int64 when every field is an integer, float64
when every field is a number or one of pandas' missing-value tokens, bool
when every field is ``True``/``False``, and text otherwise (missing
values there too); floats are written as Python's shortest round-trip
``repr`` (``1.5``, ``2.0``, ``1e-05``), as pandas writes them, and
missing values as ``na_rep``. Columns joined from several files take the
common type (int and float give float; anything with text keeps every
value as it was read). One difference: a float field is parsed with
Python's correctly rounded ``float``; pandas' parser is not correctly
rounded for every decimal string, so a value with more significant
digits than a float64 holds may be re-written one digit apart.
"""

from __future__ import annotations

import csv
import os

import numpy as np

# pandas' default missing-value tokens (``pandas._libs.parsers.STR_NA_VALUES``)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False,
          "FALSE": False, "false": False}


class Column(list):
    """One table column: its values (Python int, float, bool or str; None
    for a missing value) and its type ``kind``: "int", "float", "bool"
    or "str"."""

    def __init__(self, values, kind: str):
        super().__init__(values)
        self.kind = kind

    def array(self, dtype=None) -> np.ndarray:
        """The values as a numpy array (missing values as NaN)."""
        vals = [np.nan if v is None else v for v in self]
        if dtype is None and self.kind == "str":
            dtype = object
        return np.asarray(vals, dtype=dtype)


def _is_int(tok: str) -> bool:
    t = tok[1:] if tok[:1] in "+-" else tok
    return t.isdigit() and t.isascii()


def _infer(tokens) -> Column:
    """A column from its fields, typed as pandas' C parser types it."""
    present = [t for t in tokens if t not in NA_VALUES]
    if present and len(present) == len(tokens) and all(map(_is_int,
                                                           present)):
        return Column([int(t) for t in tokens], "int")
    if present and all(t in _BOOLS for t in present) \
            and len(present) == len(tokens):
        return Column([_BOOLS[t] for t in tokens], "bool")
    try:
        return Column([float("nan") if t in NA_VALUES else float(t)
                       for t in tokens], "float")
    except ValueError:
        return Column([None if t in NA_VALUES else t for t in tokens], "str")


def read_table(path: str) -> list:
    """The columns of a headerless tab-separated file (blank lines
    skipped), as `Column`s (``pandas.read_table(path, header=None)``)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    if not rows:
        return []
    width = max(len(r) for r in rows)
    return [_infer([r[i] if i < len(r) else "" for r in rows])
            for i in range(width)]


def concat(columns) -> Column:
    """Columns of several tables joined, with pandas' common type."""
    kinds = {c.kind for c in columns}
    vals = [v for c in columns for v in c]
    if len(kinds) == 1:
        return Column(vals, kinds.pop())
    if kinds == {"int", "float"}:
        return Column([float(v) for v in vals], "float")
    return Column(vals, "str")


def _field(v, na_rep: str) -> str:
    if v is None or (isinstance(v, float) and v != v):
        return na_rep
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    return str(v)


def write_table(path: str, columns, na_rep: str = "") -> None:
    """Write columns (`Column`s or sequences) as a headerless
    tab-separated file, as ``DataFrame.to_csv(header=False, index=False,
    sep="\\t", na_rep=na_rep)`` writes them."""
    cols = [c if isinstance(c, Column) else _as_column(c) for c in columns]
    n = len(cols[0]) if cols else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        for i in range(n):
            w.writerow([_field(c[i], na_rep) for c in cols])


def _as_column(values) -> Column:
    a = np.asarray(values)
    if a.dtype.kind in "iu":
        return Column([int(v) for v in a], "int")
    if a.dtype.kind == "f":
        return Column([float(v) for v in a], "float")
    if a.dtype.kind == "b":
        return Column([bool(v) for v in a], "bool")
    return Column(list(values), "str")


def intersect_region(file1: str, file2: str):
    """Serial-indexed interval intersection (reference `intersect_region`,
    utility.py:119-138): rows of file2 whose serial-matched row in file1
    overlaps them."""
    d1 = read_table(file1)
    d2 = read_table(file2)
    chrom1 = d1[0].array()
    start1, stop1 = d1[1].array(), d1[2].array()
    chrom2 = d2[0].array()
    start2, stop2 = d2[1].array(), d2[2].array()
    serial2 = d2[3].array(np.int64)
    flag = ((chrom1[serial2] == chrom2)
            & (start1[serial2] < stop2) & (stop1[serial2] > start2))
    return serial2[flag], serial2


def write_tobed(filename: str, output_filename: str) -> None:
    """3-column interval file -> 4-column BED with serial ids (reference
    `write_tobed`, utility.py:139-150)."""
    d = read_table(filename)
    write_table(output_filename,
                [d[0], d[1], d[2], np.arange(len(d[0]))])


def state_enrichment(chroms: np.ndarray, state_vec: np.ndarray):
    """Per-chromosome state enrichment: fraction of each state per chromosome
    over its global fraction. Returns (log2 fold change, fold change),
    both (n_chroms, n_states)."""
    chroms = np.asarray(chroms)
    state_vec = np.asarray(state_vec)
    chrom_vals = np.unique(chroms)
    state_vals = np.unique(state_vec)
    n = state_vec.shape[0]
    global_frac = np.array([(state_vec == s).mean() for s in state_vals])
    mtx = np.zeros((len(chrom_vals), len(state_vals)))
    for i, c in enumerate(chrom_vals):
        sel = state_vec[chroms == c]
        for j, s in enumerate(state_vals):
            mtx[i, j] = (sel == s).mean() if sel.size else 0.0
    fold = mtx / np.maximum(global_frac[None, :], 1e-16)
    return np.log2(fold + 1e-16), fold


def parse_alignment_blocks(filename: str, min_length: int,
                           n_species: int = 4):
    """Parse inferCARs-style multi-species alignment blocks into per-
    chromosome region lists (reference `find_region`/`find_region1`,
    utility.py:179-242): groups of `n_species` lines like
    `genome.chrN:start-stop ...`; a block is kept when all species map to the
    same chromosome (chr2 may map to chr2A/chr2B) and every span is at least
    `min_length`.

    Returns {chrom: [[start, stop, length], ...]} keyed by the first
    species' chromosome, using the first species' coordinates.
    """
    with open(filename) as f:
        lines = f.readlines()
    out = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        if line and line[0] != ">" and ":" in line and i + n_species <= len(
                lines):
            seg = lines[i:i + n_species]
            if not all(":" in s for s in seg):
                i += 1
                continue
            chrom_vec, len_vec = [], []
            ok = True
            for s in seg:
                head = s.split(" ")[0]
                try:
                    name, span = head.split(":")
                    chrom = name.split(".")[1]
                    start, stop = (int(v) for v in span.split("-"))
                except (IndexError, ValueError):
                    ok = False
                    break
                chrom_vec.append(chrom)
                len_vec.append([start, stop, stop - start])
            if ok and _same_chrom(chrom_vec) and min(
                    r[2] for r in len_vec) >= min_length:
                out.setdefault(chrom_vec[0], []).append(len_vec[0])
            i += n_species
        else:
            i += 1
    return out


def _same_chrom(chrom_vec) -> bool:
    base = chrom_vec[0]
    allowed = ({"chr2", "chr2A", "chr2B"} if base == "chr2"
               else {base})
    return all(c in allowed for c in chrom_vec)


def merge_contact_file(path1: str, output_filename: str,
                       chrom_vec=None, resolution: int = 50000) -> None:
    """Concatenate per-chromosome 3-column contact lists into one
    tab-separated file with a leading ``chrN`` label column, NaN written as
    ``NAN`` (reference ``merge_contact_file``, utility.py:49-78)."""
    if chrom_vec is None:
        chrom_vec = list(range(1, 23))
    kb = resolution // 1000
    tables = []
    for chrom in chrom_vec:
        d = read_table(f"{path1}/chr{chrom}.{kb}K.txt")
        tables.append([Column([f"chr{chrom}"] * len(d[0]), "str"),
                       d[0], d[1], d[2]])
    write_table(output_filename, [concat(c) for c in zip(*tables)],
                na_rep="NAN")


def merge_estimate_file(path1: str, species_vec, output_filename: str,
                        chrom_vec=None, output_path: str = ".") -> None:
    """Merge per-chromosome 11-column estimate exports (``test{N}.txt``:
    start1 bin1 stop1 start2 bin2 stop2 state f_1..f_S) into one file keyed
    by ``chrN``, then split one 4-column file per species (reference
    ``merge_estimate_file``, utility.py:80-117)."""
    if chrom_vec is None:
        chrom_vec = list(range(1, 23))
    tables = []
    for chrom in chrom_vec:
        d = read_table(f"{path1}/test{chrom}.txt")
        # one feature column per species (the reference hardcodes 4
        # species at utility.py:93; this port follows species_vec)
        if len(d) < 7 + len(species_vec):
            raise ValueError(
                f"test{chrom}.txt has {len(d)} columns; expected "
                f"{7 + len(species_vec)} for {len(species_vec)} species")
        sub = [d[0], d[1], d[4]] + d[7:7 + len(species_vec)]
        sub[0] = Column([f"chr{chrom}"] * len(d[0]), "str")
        tables.append(sub)
    merged = [concat(c) for c in zip(*tables)]
    write_table(output_filename, merged)
    for i, sp in enumerate(species_vec):
        write_table(os.path.join(output_path, f"estimate_{sp}.txt"),
                    [merged[0], merged[1], merged[2], merged[3 + i]])


def chrom_contactMtx(input_filename: str, chrom) -> str:
    """Rewrite a raw ``*.{res}Kb.*`` contact list as a 4-column BED
    (chrom, bin1, bin2, value) with coordinates divided by the resolution
    parsed from the filename and NaN -> -1 (reference ``chrom_contactMtx``,
    utility.py:2664-2690). Returns the output path."""
    str_vec = input_filename.split(".")
    resolution = int(str_vec[1][:str_vec[1].find("Kb")]) * 1000
    if str_vec[1].find("chr") < 0:
        chrom = f"chr{chrom}"
    d = read_table(input_filename)
    value = d[2].array(np.float64)
    value[np.isnan(value)] = -1
    n = len(d[0])
    output_filename = f"{input_filename[:input_filename.find('.txt')]}.bed"
    write_table(output_filename, [
        Column([chrom] * n, "str"),
        (d[0].array() // resolution).astype(np.int64),
        (d[1].array() // resolution).astype(np.int64), value])
    return output_filename


def overlap_openChromatin(loc1, loc2) -> list:
    """Indices of feature regions (``loc1``: dict/frame with chr/start/stop)
    overlapping any open-chromatin interval (``loc2``: [chrom, start, stop]
    columns) (reference ``overlap_openChromatin``, utility.py:2692-2723)."""
    chrom1 = np.asarray(loc1["chr"])
    start1 = np.asarray(loc1["start"])
    stop1 = np.asarray(loc1["stop"])
    chrom2, start2, stop2 = (np.asarray(loc2[0]), np.asarray(loc2[1]),
                             np.asarray(loc2[2]))
    chrom_dict = {c: np.where(chrom1 == c)[0] for c in set(chrom1)}
    sel_idx = set()
    for j in range(len(chrom2)):
        b1 = chrom_dict.get(chrom2[j])
        if b1 is None:
            continue
        hit = (start1[b1] < stop2[j]) & (stop1[b1] > start2[j])
        sel_idx.update(b1[hit].tolist())
    return sorted(sel_idx)
