"""Multi-process data-parallel EM — counterpart of
``phylo_hmrf_tpu/parallel/multiproc.py``: one process per host (or
several sharing a card), regions partitioned across processes.

Each process loads and E-steps only its own regions on its own devices;
what crosses processes is what the reference put through its mp.Queue
(``base.py:352-372``): sufficient statistics and the weighted cost
scalars, here as host tensors over the ``gloo`` process group of
`parallel.distributed.initialize_distributed`.

Consistency model: BITWISE parity with a single-process run. The init
gathers the global sample matrix (`MultiProcessPhyloHMRF._init_arrays`),
and each iteration's reduction all-gathers PER-REGION rows and re-sums
them in the single-process region order in float64 (`_global_stats`,
`_global_costs`). Per-region E-step results do not depend on which
regions share a bucket (held by the tests and, on the card, by
``chip_smoke.py``), so every process computes the trajectory a
one-process run would, and the merged ``.mat`` is that run's. Per-region
labels stay process-local, like the reference's worker-local labels.

Every payload travels as a ``uint8`` view of its contiguous bytes and is
reinterpreted on arrival, so int32 labels and float64 statistics cross
bit for bit; sums are taken on the host in process order, as the JAX
package does (gloo's own ``all_reduce`` adds in an order of its own).

Elastic recovery composes with checkpoint/resume: each process writes its
own checkpoint (the command line gives per-process paths); after a worker
failure the job restarts and resumes from the last checkpoint.
"""

from __future__ import annotations

import os

import numpy as np

from phylo_hmrf_tpu_torch.models.hmrf import PhyloHMRF
from phylo_hmrf_tpu_torch.parallel.distributed import (_collective,
                                                       process_count,
                                                       process_index)


def partition_regions(regions, n_processes: int, process_id: int):
    """Deterministic size-balanced partition: regions sorted by sample
    count, dealt snake-wise over processes. Returns (local_regions,
    n_samples_total)."""
    order = sorted(range(len(regions)),
                   key=lambda i: (-regions[i].n_samples, i))
    owner = {}
    for rank, idx in enumerate(order):
        lap, pos = divmod(rank, n_processes)
        owner[idx] = pos if lap % 2 == 0 else n_processes - 1 - pos
    local = [r for i, r in enumerate(regions) if owner[i] == process_id]
    total = int(sum(r.n_samples for r in regions))
    return local, total


def _bytes_of(arr: np.ndarray) -> np.ndarray:
    """The raw bytes of ``arr`` (C order) as a flat uint8 array."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _host_buffer(buf: np.ndarray):
    """A CPU uint8 tensor holding ``buf``, at least one byte long: every
    process sends a well-formed tensor, an empty share too."""
    import torch

    t = torch.zeros(max(buf.size, 1), dtype=torch.uint8)
    t[:buf.size] = torch.from_numpy(buf.copy())
    return t


def _all_gather_bytes(buf: np.ndarray) -> list:
    """Every process's ``buf`` (equal lengths), in process order."""
    import torch
    import torch.distributed as dist

    t = _host_buffer(buf)
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return [o.numpy()[:buf.size] for o in out]


def _broadcast_bytes(buf: np.ndarray) -> np.ndarray:
    """Process 0's ``buf`` (equal lengths everywhere)."""
    import torch.distributed as dist

    t = _host_buffer(buf)
    dist.broadcast(t, src=0)
    return t.numpy()[:buf.size]


def _allreduce_sum(x: np.ndarray) -> np.ndarray:
    """Sum an identical-shaped host array across all processes, in float64
    on the host in process order (the JAX package's order). BIT-EXACT:
    the payload travels as its raw bytes, so sample counts above 2^24 stay
    exact."""
    x = np.asarray(x, np.float64)
    if process_count() == 1:
        return x
    parts = _collective(_all_gather_bytes, _bytes_of(x))
    gathered = np.stack([p.view(np.float64).reshape(x.shape)
                         for p in parts])
    return np.sum(gathered, axis=0)


def _broadcast_from_zero(arr: np.ndarray) -> np.ndarray:
    """Bit-exact broadcast of process 0's array to every process.

    The LEADING dimension may differ across processes beforehand (e.g.
    each host loaded a different cached quantile file): the result
    everywhere is process 0's array; trailing dims and dtype must already
    agree."""
    if process_count() == 1:
        return arr
    arr = np.ascontiguousarray(arr)
    n0 = _collective(_broadcast_bytes,
                     _bytes_of(np.asarray([arr.shape[0]], np.int64)))
    n0 = int(n0.view(np.int64)[0])
    buf = np.zeros((n0,) + arr.shape[1:], arr.dtype)
    buf[:min(n0, arr.shape[0])] = arr[:n0]
    out = _collective(_broadcast_bytes, _bytes_of(buf))
    return out.view(arr.dtype).reshape(buf.shape)


def _allgather_ragged(arr: np.ndarray):
    """Gather a per-process array whose LEADING dimension differs across
    processes; trailing dims and dtype must match. Returns the
    per-process list (pad to the largest count, one all-gather of the raw
    bytes, slice back). A process with zero rows still sends a tensor."""
    if process_count() == 1:
        return [arr]
    counts = _collective(_all_gather_bytes,
                         _bytes_of(np.asarray([arr.shape[0]], np.int64)))
    counts = [int(c.view(np.int64)[0]) for c in counts]
    maxn = max(counts)
    pad = np.zeros((maxn,) + arr.shape[1:], arr.dtype)
    pad[:arr.shape[0]] = arr
    parts = _collective(_all_gather_bytes, _bytes_of(pad))
    return [p.view(arr.dtype).reshape(pad.shape)[:n]
            for p, n in zip(parts, counts)]


class MultiProcessPhyloHMRF(PhyloHMRF):
    """PhyloHMRF over this process's region subset; stats/costs reduce
    globally. Construct with the LOCAL regions and the GLOBAL sample count
    (see `partition_regions`)."""

    def __init__(self, tree, local_regions, config=None, *,
                 n_samples_total: int, mesh=None, device=None,
                 chrom_order=None):
        super().__init__(tree, local_regions, config, mesh=mesh,
                         device=device)
        self.n_samples_total = int(n_samples_total)
        # global region order for cross-process assembly: chromosomes in
        # chrom_order (the CLI's chrom_vec), regions by region_id within
        self.chrom_order = (list(chrom_order) if chrom_order is not None
                            else None)

    def _region_key(self, r):
        # two disjoint key spaces: chromosomes in chrom_order sort by their
        # position [0, len); any chromosome absent from the list sorts
        # after them by raw number (len + c) — mixing index-space with raw
        # numbers would let e.g. order-position 0 collide with raw chrom 0
        # and scramble the global region order the gather relies on
        c = int(r.chrom)
        if self.chrom_order is not None:
            c = (self.chrom_order.index(c) if c in self.chrom_order
                 else len(self.chrom_order) + c)
        return (c, int(r.region_id))

    def _init_arrays(self):
        """Gather every process's flat samples so k-means and the
        per-cluster OU fits see the SAME global X (in single-process region
        order) a one-process run would — initialization is then bitwise
        reproducible regardless of the partition. The global X is only
        materialized transiently here; the EM itself stays local."""
        if process_count() == 1:
            return super()._init_arrays()
        meta = np.asarray(
            [list(self._region_key(r)) + [r.n_samples]
             for r in self.regions], np.int64).reshape(-1, 3)
        metas = _allgather_ragged(meta)
        values = _allgather_ragged(self.flat_values())
        shards = []
        for p, (rows, Xp) in enumerate(zip(metas, values)):
            off = 0
            for li, row in enumerate(rows):
                n = int(row[2])
                shards.append(((int(row[0]), int(row[1])),
                               Xp[off:off + n], p, li))
                off += n
        shards.sort(key=lambda s: s[0])
        X = np.concatenate([s[1] for s in shards], axis=0)
        slices = [None] * len(self.regions)
        off = 0
        me = process_index()
        for _, xs, p, li in shards:
            if p == me:
                slices[li] = (off, off + xs.shape[0])
            off += xs.shape[0]
        return X, slices

    def _sync_init(self, centers, labels):
        """Broadcast process 0's k-means result bit-exactly: the labels
        seed labels_local (the warm-start grids), so a single near-tied
        assignment flipping on one process would fork that process's
        whole EM trajectory from the others'."""
        if process_count() == 1:
            return centers, labels
        return (_broadcast_from_zero(np.asarray(centers, np.float64)),
                _broadcast_from_zero(np.ascontiguousarray(labels)))

    def initialize(self):
        """Global-X k-means/OU init (see `_init_arrays`, `_sync_init`),
        then broadcast process 0's parameters as a belt-and-braces
        determinism guard (identical inputs should already yield
        identical fits)."""
        super().initialize()
        if process_count() > 1:
            self.params_vec = _broadcast_from_zero(self.params_vec)
            self.init_ou_params = _broadcast_from_zero(self.init_ou_params)
            self.means_ = _broadcast_from_zero(self.means_)
            self.covars_ = _broadcast_from_zero(self.covars_)

    def _gather_region_rows(self, arr: np.ndarray) -> np.ndarray:
        """Allgather per-region rows from every process and rebuild the
        global (R_global, ...) array in single-process region order
        (chrom_vec order, region_id within). The result is a C-contiguous
        f64 array identical to the one a single-process run holds, so the
        subsequent numpy reduction is bitwise identical too."""
        keys = np.asarray([list(self._region_key(r))
                           for r in self.regions], np.int64).reshape(-1, 2)
        keys_g = np.concatenate(_allgather_ragged(keys), axis=0)
        rows_g = np.concatenate(_allgather_ragged(
            np.ascontiguousarray(np.asarray(arr, np.float64))), axis=0)
        order = np.lexsort((keys_g[:, 1], keys_g[:, 0]))
        return np.ascontiguousarray(rows_g[order])

    def _global_stats(self, stats):
        return tuple(self._gather_region_rows(s).sum(0) for s in stats)

    def _global_costs(self, costs: np.ndarray,
                      ratio_vec: np.ndarray) -> np.ndarray:
        costs_g = self._gather_region_rows(costs)
        ratio_g = self._gather_region_rows(
            np.asarray(ratio_vec).reshape(-1, 1))[:, 0]
        return costs_g.T @ ratio_g


# ---------------------------------------------------------------------------
# host-local loading and one global result
# ---------------------------------------------------------------------------

def estimate_chrom_samples(chrom, synteny_dir: str, cfg) -> int:
    """Structural sample-count estimate for one chromosome from synteny
    metadata ALONE (a tiny text file — no contact IO): a diagonal block of
    B bins holds ~B(B+1)/2 upper-triangle samples, an off-diagonal block
    H x W. Exact counts need the contact positions (the raster window is
    data-dependent), but for load balancing the block spans are enough."""
    from phylo_hmrf_tpu_torch.data.synteny import subregion1

    path = os.path.join(synteny_dir, f"chr{chrom}.synteny.txt")
    _, pairs = subregion1(path, chrom, cfg.resolution,
                          cfg.centromere_splits)
    if cfg.diagonal_type == 1:
        pairs = [p for p in pairs if p[0] == p[2] and p[1] == p[3]]
    n = 0
    for p in pairs:
        h = (p[1] - p[0]) // cfg.resolution + 1
        w = (p[3] - p[2]) // cfg.resolution + 1
        n += h * (h + 1) // 2 if (p[0] == p[2] and p[1] == p[3]) else h * w
    return int(n)


def partition_chromosomes(chrom_vec, synteny_dir: str, cfg,
                          n_processes: int, process_id: int):
    """Deterministic snake partition of chromosomes by estimated sample
    count, decided BEFORE any contact loading so each process reads only
    its own chromosomes (the reference's per-chromosome loader boundary,
    utility.py:284-298, is the split). Returns this process's chromosome
    list in global chrom_vec order."""
    est = {c: estimate_chrom_samples(c, synteny_dir, cfg)
           for c in chrom_vec}
    order = sorted(range(len(chrom_vec)),
                   key=lambda i: (-est[chrom_vec[i]], i))
    local = []
    for rank, idx in enumerate(order):
        lap, pos = divmod(rank, n_processes)
        owner = pos if lap % 2 == 0 else n_processes - 1 - pos
        if owner == process_id:
            local.append(chrom_vec[idx])
    local.sort(key=chrom_vec.index)
    return local


def estimate_region_samples(chrom, synteny_dir: str, cfg):
    """Per-region structural sample estimates for one chromosome:
    [(region_id, n_est), ...] in synteny order (same estimate as
    `estimate_chrom_samples`, per region instead of summed)."""
    from phylo_hmrf_tpu_torch.data.synteny import subregion1

    path = os.path.join(synteny_dir, f"chr{chrom}.synteny.txt")
    _, pairs = subregion1(path, chrom, cfg.resolution,
                          cfg.centromere_splits)
    if cfg.diagonal_type == 1:
        pairs = [p for p in pairs if p[0] == p[2] and p[1] == p[3]]
    out = []
    for p in pairs:
        h = (p[1] - p[0]) // cfg.resolution + 1
        w = (p[3] - p[2]) // cfg.resolution + 1
        n = h * (h + 1) // 2 if (p[0] == p[2] and p[1] == p[3]) else h * w
        out.append((int(p[7]), int(n)))
    return out


def partition_chromosome_regions(chrom_vec, synteny_dir: str, cfg,
                                 n_processes: int, process_id: int):
    """Region-granularity partition for runs with more processes than
    chromosomes (the reference's own finer fan-out: one worker per region
    within a chromosome, utility.py:422-435). All (chromosome, region)
    units across chrom_vec are snake-dealt by estimated sample count,
    decided from synteny metadata alone BEFORE any contact loading.

    Returns (local_chroms, region_filters): the chromosomes this process
    must load (in chrom_vec order; may be empty when there are more
    processes than regions) and {chrom: sorted [region_id, ...]} naming
    which of each chromosome's regions to keep. A process with an empty
    share still participates in every collective (zero-row gathers)."""
    units = []                              # (chrom, region_id, n_est)
    for c in chrom_vec:
        for rid, n in estimate_region_samples(c, synteny_dir, cfg):
            units.append((c, rid, n))
    order = sorted(range(len(units)), key=lambda i: (-units[i][2], i))
    filters = {}
    for rank, idx in enumerate(order):
        lap, pos = divmod(rank, n_processes)
        owner = pos if lap % 2 == 0 else n_processes - 1 - pos
        if owner == process_id:
            c, rid, _ = units[idx]
            filters.setdefault(c, []).append(rid)
    for c in filters:
        filters[c].sort()
    local_chroms = [c for c in chrom_vec if c in filters]
    return local_chroms, filters


def quantile_scan_chromosomes(chrom_vec, synteny_dir: str, cfg,
                              region_filters):
    """The subset of this process's chromosomes it should quantile-scan
    under a REGION-granularity partition: exactly ONE process owns each
    chromosome's scan — the one holding the chromosome's lowest region_id
    (deterministic from synteny metadata alone, no collective).

    Without this, every process owning ANY region of a chromosome would
    scan and contribute that chromosome's full (S, 10) quantile block,
    and the gathered multiset would duplicate chromosomes unevenly —
    silently shifting x_max = median(col 6) away from the
    single-process/reference value (phylo_hmrf.py:1662-1663) whenever
    per-chromosome owner counts differ."""
    out = []
    for c in chrom_vec:
        if c not in region_filters:
            continue
        rids = [rid for rid, _ in
                estimate_region_samples(c, synteny_dir, cfg)]
        if rids and min(rids) in region_filters[c]:
            out.append(c)
    return out


def gather_quantile_rows(m_vec_local: np.ndarray, scan_chroms=None,
                         chrom_vec=None) -> np.ndarray:
    """Allgather per-(chromosome, species) quantile rows so every process
    computes the same global x_max from only its locally scanned
    chromosomes.

    With `scan_chroms`/`chrom_vec` (region-granularity partitions), each
    row is keyed by (chromosome position in chrom_vec, within-chromosome
    row index) and the merged matrix is re-sorted to the exact
    single-process row order — so both x_max and the
    chrom_quantile_test.txt file written by process 0 are byte-identical
    to a single-process scan. Duplicate chromosome blocks (which
    quantile_scan_chromosomes prevents at the source) are dropped
    defensively, keeping one block per chromosome. Without keys
    (chromosome-granularity partitions, where each chromosome is scanned
    exactly once), rows are concatenated in process order; the only
    consumer is the MEDIAN of column 6 (x_max_from_quantiles), which is
    order-invariant."""
    m_vec_local = np.asarray(m_vec_local, np.float64)
    if scan_chroms is None:
        return np.concatenate(_allgather_ragged(m_vec_local), axis=0)
    if chrom_vec is None:
        raise ValueError("keyed gather_quantile_rows needs chrom_vec")
    n_chr = len(scan_chroms)
    per = m_vec_local.shape[0] // n_chr if n_chr else 0
    pos = {int(c): i for i, c in enumerate(chrom_vec)}
    keys = np.zeros((m_vec_local.shape[0], 2), np.float64)
    for i, c in enumerate(scan_chroms):
        keys[i * per:(i + 1) * per, 0] = pos[int(c)]
        keys[i * per:(i + 1) * per, 1] = np.arange(per)
    tagged = np.concatenate([keys, m_vec_local], axis=1)
    rows = np.concatenate(_allgather_ragged(tagged), axis=0)
    out, seen = [], set()
    for row in rows[np.lexsort((rows[:, 1], rows[:, 0]))]:
        key = (int(row[0]), int(row[1]))
        if key in seen:
            continue
        seen.add(key)
        out.append(row[2:])
    return (np.asarray(out, np.float64) if out
            else np.zeros((0, m_vec_local.shape[1]), np.float64))


def gather_global_result(model, result, chrom_vec):
    """Assemble the single-run state_vec/len_vec from all processes' local
    region shards (identical on every process; process 0 writes the one
    reference-schema .mat, phylo_hmrf.py:1743-1748).

    Region order matches a single-process run: chromosomes in chrom_vec
    order, regions in synteny order (region_id) within a chromosome.
    Returns (state_vec (N_global,), len_vec (R_global, 10))."""
    chrom_pos = {int(c): i for i, c in enumerate(chrom_vec)}
    meta = []
    off = 0
    for r in model.regions:
        meta.append([chrom_pos[int(r.chrom)], int(r.region_id),
                     r.n_samples, r.H0, r.W0, r.start1, r.start2,
                     1 if r.is_diag else 0, int(r.chrom), off])
        off += r.n_samples
    meta = np.asarray(meta, np.int64).reshape(-1, 10)
    metas = _allgather_ragged(meta)
    labels = _allgather_ragged(
        np.asarray(result.labels, np.int64).reshape(-1, 1))

    shards = []
    for rows, labs in zip(metas, labels):
        labs = labs[:, 0]
        for row in rows:
            (cpos, rid, n, H0, W0, s1, s2, tid, chrom, loc_off) = row
            shards.append(((int(cpos), int(rid)),
                           [int(n), 0, 0, int(H0), int(W0), int(s1),
                            int(s2), int(rid), int(tid), int(chrom)],
                           labs[loc_off:loc_off + n]))
    shards.sort(key=lambda s: s[0])
    state_vec = np.concatenate([s[2] for s in shards])
    len_vec = []
    off = 0
    for _, row, lab in shards:
        row[1], row[2] = off, off + row[0]
        off += row[0]
        len_vec.append(row)
    return state_vec, np.asarray(len_vec, np.int64)
