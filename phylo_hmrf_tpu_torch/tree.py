"""Phylogenetic tree preprocessing — the port's own copy of
``phylo_hmrf_tpu/tree.py`` (``PhyloTree``, ``build_tree``, ``load_tree``,
``save_debug_dumps``, ``base_matrices``), numpy only.

Parses the reference's tree input files (``edge.1.txt``, ``branch_length.1.txt``,
``species_name.1.txt``) and precomputes the static index structures the OU
emission model needs, as dense numpy arrays:

* ``parent``        — parent index per node (root's parent is itself)
* ``topo_order``    — node indices in root-to-leaf topological order
* ``leaf_nodes``    — node indices of leaves, in increasing node order; leaf
                      position i corresponds to feature column i (species i)
* ``A1``            — (n_leaves, n_nodes) indicator of each leaf's parent
* ``A2``            — (n_pairs, n_nodes) indicator of branches strictly below
                      the MRCA on the path between each leaf pair
* ``pair_*``        — per leaf pair: MRCA node and the two leaf positions

Behavioral parity: reference ``phylo_hmrf.py:714-919`` (``_initilize_tree_mtx``,
``_sub_tree_leaf``, ``_search_leaf``, ``_search_ancestor``, ``_matrix1``).
The reference assumes node indices are already topologically ordered (its
mean/variance recursion walks ``range(1, n_nodes)``); we compute an explicit
topological order so arbitrary labelings also work.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class PhyloTree:
    """Static tree structure. All arrays are numpy (host) constants.

    Hashable by content, like the JAX package's tree: two trees built from
    the same edge list compare equal."""

    n_nodes: int
    parent: np.ndarray        # (n_nodes,) int32; parent[root] == root
    topo_order: np.ndarray    # (n_nodes,) int32, topo_order[0] == root
    leaf_nodes: np.ndarray    # (n_leaves,) int32, increasing
    A1: np.ndarray            # (n_leaves, n_nodes) float32
    A2: np.ndarray            # (n_pairs, n_nodes) float32
    pair_mrca: np.ndarray     # (n_pairs,) int32 — MRCA node index per leaf pair
    pair_rows: np.ndarray     # (n_pairs,) int32 — leaf position of first leaf
    pair_cols: np.ndarray     # (n_pairs,) int32 — leaf position of second leaf
    pair_list: np.ndarray     # (n_pairs, 3) int32 — [leaf_node_i, leaf_node_j, mrca]
    branch_lengths: np.ndarray | None = None   # (n_branches,) float64 or None
    species: tuple = ()

    def _content(self) -> tuple:
        return (self.n_nodes, self.parent.tobytes(),
                self.topo_order.tobytes(), self.leaf_nodes.tobytes(),
                self.A2.tobytes(), self.pair_list.tobytes())

    def __hash__(self):
        return hash(self._content())

    def __eq__(self, other):
        return (isinstance(other, PhyloTree)
                and self._content() == other._content())

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_nodes.shape[0])

    @property
    def n_branches(self) -> int:
        # every non-root node owns the branch to its parent
        return self.n_nodes - 1

    @property
    def n_params(self) -> int:
        """Per-state OU parameter count: [sigma2_root, alpha_1..B, lambda_1..B,
        theta_0..theta_B] (reference `phylo_hmrf.py:107`)."""
        return self.n_nodes + 2 * self.n_branches + 1

    @property
    def root(self) -> int:
        return int(self.topo_order[0])


def build_tree(edge_list, branch_lengths=None, species=()) -> PhyloTree:
    """Build the static tree structure from a (parent, child) edge list."""
    edges = np.asarray(edge_list, dtype=np.int64)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edge list must be (n_edges, 2), got {edges.shape}")
    n_nodes = int(edges.max()) + 1

    parent = np.full(n_nodes, -1, dtype=np.int32)
    children = [[] for _ in range(n_nodes)]
    for p, c in edges:
        # the reference normalizes each edge so the smaller index is the parent
        # (`_initilize_tree_mtx`, reference phylo_hmrf.py:715-725)
        p, c = (int(min(p, c)), int(max(p, c)))
        if parent[c] != -1:
            raise ValueError(f"node {c} has two parents")
        parent[c] = p
        children[p].append(c)

    roots = np.where(parent == -1)[0]
    if len(roots) != 1:
        raise ValueError(f"tree must have exactly one root, found {roots}")
    root = int(roots[0])
    parent[root] = root

    # topological order (BFS from the root; deterministic child order)
    topo = [root]
    frontier = [root]
    while frontier:
        nxt = []
        for u in frontier:
            nxt.extend(children[u])
        topo.extend(nxt)
        frontier = nxt
    if len(topo) != n_nodes:
        raise ValueError("edge list does not describe a connected tree")
    topo_order = np.asarray(topo, dtype=np.int32)

    leaf_nodes = np.asarray(
        [i for i in range(n_nodes) if not children[i]], dtype=np.int32)
    n_leaves = len(leaf_nodes)
    leaf_pos = {int(n): i for i, n in enumerate(leaf_nodes)}

    # root-to-leaf ancestor paths (reference `_search_ancestor`)
    def path(leaf):
        p = [int(leaf)]
        u = int(leaf)
        while u != root:
            u = int(parent[u])
            p.append(u)
        return p[::-1]

    paths = {int(l): path(l) for l in leaf_nodes}

    A1 = np.zeros((n_leaves, n_nodes), dtype=np.float32)
    for i, l in enumerate(leaf_nodes):
        A1[i, parent[l]] = 1.0

    n_pairs = n_leaves * (n_leaves - 1) // 2
    A2 = np.zeros((n_pairs, n_nodes), dtype=np.float32)
    pair_mrca = np.zeros(n_pairs, dtype=np.int32)
    pair_rows = np.zeros(n_pairs, dtype=np.int32)
    pair_cols = np.zeros(n_pairs, dtype=np.int32)
    pair_list = np.zeros((n_pairs, 3), dtype=np.int32)
    cnt = 0
    for i in range(n_leaves):
        for j in range(i + 1, n_leaves):
            li, lj = int(leaf_nodes[i]), int(leaf_nodes[j])
            pi, pj = paths[li], paths[lj]
            common = set(pi) & set(pj)
            mrca = max(common)  # deepest common ancestor (matches `_matrix1`)
            below_i = [u for u in pi if u not in common]
            below_j = [u for u in pj if u not in common]
            A2[cnt, below_i] = 1.0
            A2[cnt, below_j] = 1.0
            pair_mrca[cnt] = mrca
            pair_rows[cnt] = leaf_pos[li]
            pair_cols[cnt] = leaf_pos[lj]
            pair_list[cnt] = (li, lj, mrca)
            cnt += 1

    bl = None
    if branch_lengths is not None:
        bl = np.asarray(branch_lengths, dtype=np.float64).ravel()

    return PhyloTree(
        n_nodes=n_nodes, parent=parent, topo_order=topo_order,
        leaf_nodes=leaf_nodes, A1=A1, A2=A2, pair_mrca=pair_mrca,
        pair_rows=pair_rows, pair_cols=pair_cols, pair_list=pair_list,
        branch_lengths=bl, species=tuple(species))


def load_tree(edge_file: str, branch_file: str | None = None,
              species_file: str | None = None) -> PhyloTree:
    """Load a tree from the reference input-file formats.

    ``edge.1.txt``: one tab-separated ``parent<TAB>child`` pair per line.
    ``branch_length.1.txt``: one tab-separated row of branch lengths.
    ``species_name.1.txt``: one species name per line, in feature order.
    """
    edges = []
    with open(edge_file) as f:
        for line in f:
            line = line.strip()
            if line:
                a, b = line.split("\t")
                edges.append((int(a), int(b)))

    branch_lengths = None
    if branch_file is not None:
        with open(branch_file) as f:
            row = f.readline().strip()
            branch_lengths = [float(v) for v in row.split("\t")]

    species = ()
    if species_file is not None:
        with open(species_file) as f:
            species = tuple(line.strip() for line in f if line.strip())

    return build_tree(edges, branch_lengths, species)


def save_debug_dumps(tree: PhyloTree, output_dir: str = ".") -> None:
    """Write the golden-compatible debug dumps the reference emits
    (``ou_A1.txt``, ``ou_A2.txt``, ``base_mtx_*`` — reference
    phylo_hmrf.py:806-807, 914-917) so downstream tooling can diff them."""
    import os

    np.savetxt(os.path.join(output_dir, "ou_A1.txt"), tree.A1,
               fmt="%d", delimiter="\t")
    np.savetxt(os.path.join(output_dir, "ou_A2.txt"), tree.A2,
               fmt="%d", delimiter="\t")
    for i, mtx in enumerate(base_matrices(tree)):
        np.savetxt(os.path.join(output_dir, f"base_mtx_{i}"), mtx,
                   fmt="%d", delimiter="\t")


def base_matrices(tree: PhyloTree) -> list:
    """Per-node leaf-pair indicator matrices (reference `_compute_base_mtx`):
    base[k][i, j] = 1 iff node k is the MRCA of leaf pair (i, j) (diagonal set
    for the leaf's own ancestors chain membership). Root's matrix is all-ones."""
    L = tree.n_leaves
    out = [np.zeros((L, L)) for _ in range(tree.n_nodes)]
    out[tree.root] = np.ones((L, L))
    # reachable leaf sets per node
    reach = [[] for _ in range(tree.n_nodes)]
    for node in tree.topo_order[::-1]:
        node = int(node)
        kids = [c for c in range(tree.n_nodes)
                if int(tree.parent[c]) == node and c != node]
        if not kids:
            reach[node] = [node]
        else:
            for c in kids:
                reach[node].extend(reach[c])
    leaf_pos = {int(n): i for i, n in enumerate(tree.leaf_nodes)}
    for k in range(tree.n_nodes):
        if k == tree.root:
            continue
        ls = reach[k]
        for a in range(len(ls)):
            for b in range(a, len(ls)):
                i, j = leaf_pos[ls[a]], leaf_pos[ls[b]]
                out[k][i, j] = 1
                out[k][j, i] = 1
    return out
