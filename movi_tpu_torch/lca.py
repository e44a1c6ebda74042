"""Copy of movi_tpu/lca.py: the port keeps its own, so it imports nothing
of the JAX package.

Taxonomic LCA post-processing and tree-compressed colors.

Ports:
  - src/lca_classification.py: resolve (primary, secondary) multi-class
    calls to their lowest common ancestor in an NCBI-style nodes.dmp tree.
  - build_tree_doc_sets (move_structure_color.cpp:195-292): hierarchical
    clustering of documents by doc-set co-occurrence; every doc set is
    compressed to the LCA cluster node (scipy replaces hclust-cpp).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

ROOT_TAXON = 1
UNDEFINED_TAXON = 0


def load_nodes_dmp(path: str) -> Dict[int, int]:
    """nodes.dmp: child -> parent taxon map (tab-separated columns 0, 2)."""
    parent: Dict[int, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                parent[int(parts[0])] = int(parts[2])
    return parent


def find_lca(taxon1: int, taxon2: int, parent: Dict[int, int]) -> int:
    """src/lca_classification.py:14-30 semantics."""
    if taxon2 == UNDEFINED_TAXON:
        return taxon1
    if taxon1 == taxon2:
        return taxon1
    lineage = set()
    t = taxon1
    while t != ROOT_TAXON:
        lineage.add(t)
        t = parent.get(t, ROOT_TAXON)
    t = taxon2
    while t != ROOT_TAXON:
        if t in lineage:
            return t
        t = parent.get(t, ROOT_TAXON)
    return ROOT_TAXON


def lca_postprocess(csv_rows: Iterable[str], parent: Dict[int, int]
                    ) -> List[str]:
    """Append the lca column to 'name,primary,secondary' rows."""
    out = []
    for row in csv_rows:
        name, a, b = row.rsplit(",", 2)
        lca = find_lca(int(a), int(b), parent)
        out.append(f"{row},{lca}")
    return out


# ---------------------------------------------------------------------------
def build_doc_set_similarities(ct) -> np.ndarray:
    """build_doc_set_similarities (move_structure_color.cpp:294-320):
    similarity[i][j] = number of runs whose doc set contains both i, j."""
    num = ct.doc_info.num_species
    cnts = np.bincount(ct.doc_set_inds, minlength=len(ct.unique_doc_sets))
    sim = np.zeros((num, num), dtype=np.int64)
    for i, docs in enumerate(ct.unique_doc_sets):
        d = np.asarray(docs, dtype=np.int64)
        if len(d) > 1:
            sim[np.ix_(d, d)] += cnts[i]
    np.fill_diagonal(sim, 0)
    return np.triu(sim) + np.triu(sim, 1).T  # symmetric


def tree_compress_color_table(ct, r: int):
    """build_tree_doc_sets: average-linkage clustering on
    1 - similarity/r distances; every unique doc set maps to the LCA
    cluster node whose member set replaces it."""
    from scipy.cluster.hierarchy import linkage
    from scipy.spatial.distance import squareform

    from .color import ColorTable

    num = ct.doc_info.num_species
    sim = build_doc_set_similarities(ct)
    dist = 1.0 - sim / float(r)
    np.fill_diagonal(dist, 0.0)
    condensed = squareform(dist, checks=False)
    Z = linkage(condensed, method="average")

    nodes = 2 * num - 1
    tree_doc_sets: List[List[int]] = [[i] for i in range(num)]
    tree_doc_sets += [[] for _ in range(num - 1)]
    parent = np.full(nodes, nodes - 1, dtype=np.int64)
    for i in range(num - 1):
        a, b = int(Z[i, 0]), int(Z[i, 1])
        node = num + i
        tree_doc_sets[node] = sorted(tree_doc_sets[a] + tree_doc_sets[b])
        parent[a] = node
        parent[b] = node

    # Euler-tour ancestor test via in/out times
    children: List[List[int]] = [[] for _ in range(nodes)]
    for v in range(nodes - 1):
        children[parent[v]].append(v)
    t_in = np.zeros(nodes, dtype=np.int64)
    t_out = np.zeros(nodes, dtype=np.int64)
    timer = 0
    stack = [(nodes - 1, False)]
    while stack:
        v, done = stack.pop()
        if done:
            t_out[v] = timer
            timer += 1
        else:
            t_in[v] = timer
            timer += 1
            stack.append((v, True))
            for c in children[v]:
                stack.append((c, False))

    def is_anc(x, y):
        return t_in[x] <= t_in[y] and t_out[x] >= t_out[y]

    def lca_node(x, y):
        while not is_anc(x, y):
            x = parent[x]
        return x

    compress_to = np.zeros(len(ct.unique_doc_sets), dtype=np.int64)
    for i, docs in enumerate(ct.unique_doc_sets):
        node = int(docs[0])
        for d in docs[1:]:
            node = int(lca_node(node, int(d)))
        compress_to[i] = node

    return ColorTable(
        doc_pats=ct.doc_pats,
        doc_set_inds=compress_to[ct.doc_set_inds],
        unique_doc_sets=[np.asarray(s, dtype=np.uint16)
                         for s in tree_doc_sets],
        doc_info=ct.doc_info,
    )
