"""Network topologies of Table II.

Each generator returns a dense boolean adjacency matrix [V, V] with both
directions of every (undirected) physical link, matching the paper's
strongly-connected directed-graph assumption.  Abilene/GEANT/LHC use the
standard published node/edge lists (the paper cites the Rossi-Rossini CCN
dataset); Fog follows Kamran et al. [22] (tree + intra-layer chains); SW
follows Kleinberg [24] (ring + short/long-range chords).
"""
from __future__ import annotations

import numpy as np


def _sym(V, edges):
    A = np.zeros((V, V), dtype=bool)
    for i, j in edges:
        A[i, j] = True
        A[j, i] = True
    np.fill_diagonal(A, False)
    return A


def line(V: int) -> np.ndarray:
    return _sym(V, [(i, i + 1) for i in range(V - 1)])


def connected_er(V: int = 20, n_extra: int = 20, seed: int = 0) -> np.ndarray:
    """Connectivity-guaranteed Erdős–Rényi: line graph + random chords.

    Paper: |V|=20, |E|=40 undirected links -> 19 line edges + 21 chords.
    """
    rng = np.random.RandomState(seed)
    edges = [(i, i + 1) for i in range(V - 1)]
    have = set(edges)
    while len(edges) < (V - 1) + n_extra:
        i, j = rng.randint(0, V, 2)
        if i == j:
            continue
        e = (min(i, j), max(i, j))
        if e in have:
            continue
        have.add(e)
        edges.append(e)
    return _sym(V, edges)


def balanced_tree(depth: int = 3, branch: int = 2) -> np.ndarray:
    """Complete binary tree; depth=3, branch=2 -> 15 nodes, 14 edges."""
    V = sum(branch ** k for k in range(depth + 1))
    edges = []
    for i in range(V):
        for c in range(branch):
            child = branch * i + 1 + c
            if child < V:
                edges.append((i, child))
    return _sym(V, edges)


def fog(layers=(1, 2, 4, 12)) -> np.ndarray:
    """Fog topology [22]: tree across layers + linear chains within layers.

    Default (1,2,4,12): 19 nodes, 18 tree + 12 chain edges ≈ Table II's 30.
    """
    V = sum(layers)
    starts = np.cumsum([0] + list(layers))
    edges = []
    for l in range(1, len(layers)):
        parents = range(starts[l - 1], starts[l])
        children = list(range(starts[l], starts[l + 1]))
        np_par = list(parents)
        for idx, c in enumerate(children):
            p = np_par[idx * len(np_par) // len(children)]
            edges.append((p, c))
    for l in range(1, len(layers)):
        nodes = list(range(starts[l], starts[l + 1]))
        for a, b in zip(nodes, nodes[1:]):
            edges.append((a, b))
    return _sym(V, edges)


# Abilene (Internet2 predecessor): 11 PoPs, 14 links.
_ABILENE_EDGES = [
    (0, 1), (1, 2), (1, 3), (2, 4), (3, 4), (3, 5), (4, 6), (5, 7),
    (6, 8), (7, 8), (7, 9), (8, 10), (9, 10), (0, 2),
]


def abilene() -> np.ndarray:
    return _sym(11, _ABILENE_EDGES)


# LHC computing-grid topology (16 sites, 31 links) as used in the
# caching/computing literature the paper draws scenarios from.
_LHC_EDGES = [
    (0, 1), (0, 2), (0, 3), (1, 2), (1, 4), (2, 5), (3, 6), (4, 7),
    (5, 7), (6, 7), (4, 8), (5, 9), (6, 10), (8, 11), (9, 11), (10, 12),
    (11, 13), (12, 13), (13, 14), (14, 15), (12, 15), (8, 9), (9, 10),
    (2, 4), (3, 5), (1, 6), (7, 11), (10, 14), (0, 8), (5, 12), (6, 9),
]


def lhc() -> np.ndarray:
    return _sym(16, _LHC_EDGES)


# GEANT pan-European research network: 22 nodes, 33 links (2011 snapshot).
_GEANT_EDGES = [
    (0, 1), (0, 2), (1, 3), (1, 6), (2, 3), (2, 4), (3, 5), (4, 5),
    (4, 7), (5, 8), (6, 8), (6, 9), (7, 8), (7, 10), (8, 11), (9, 12),
    (10, 11), (10, 13), (11, 14), (12, 14), (12, 15), (13, 16), (14, 17),
    (15, 18), (16, 17), (16, 19), (17, 18), (18, 20), (19, 20), (19, 21),
    (20, 21), (9, 15), (13, 21),
]


def geant() -> np.ndarray:
    return _sym(22, _GEANT_EDGES)


def small_world(V: int = 100, n_short: int = 100, n_long: int = 120,
                seed: int = 0) -> np.ndarray:
    """Kleinberg small-world: ring + distance-2 chords + random long-range.

    Defaults give 100 + 100 + 120 = 320 undirected links (Table II SW).
    """
    rng = np.random.RandomState(seed)
    edges = [(i, (i + 1) % V) for i in range(V)]
    have = set(tuple(sorted(e)) for e in edges)
    shorts = [(i, (i + 2) % V) for i in range(V)]
    rng.shuffle(shorts)
    for e in shorts:
        if len(edges) >= V + n_short:
            break
        t = tuple(sorted(e))
        if t not in have:
            have.add(t)
            edges.append(e)
    while len(edges) < V + n_short + n_long:
        i, j = rng.randint(0, V, 2)
        if i == j:
            continue
        t = tuple(sorted((i, j)))
        if t in have:
            continue
        have.add(t)
        edges.append(t)
    return _sym(V, edges)


def barabasi_albert(V: int = 1000, m: int = 2, seed: int = 0) -> np.ndarray:
    """Barabási–Albert preferential attachment: start from an (m+1)-clique,
    then each new node attaches to `m` distinct existing nodes with
    probability proportional to their current degree.

    The degree distribution is a power law (P(d) ~ d^-3): almost all
    nodes sit at degree ~m while a few hubs reach O(√V) — the ragged
    regime the degree-bucketed engine exists for (a global [V, Dmax]
    tile wastes ~Dmax/(2m) of its lanes here).  Sampling uses the
    standard repeated-nodes list (each edge endpoint appended once), so
    building V=10⁵ takes O(E) time.  Connected by construction.
    """
    if V <= m:
        raise ValueError(f"barabasi_albert needs V > m (got V={V}, m={m})")
    rng = np.random.RandomState(seed)
    edges = [(i, j) for i in range(m + 1) for j in range(i + 1, m + 1)]
    # degree-proportional sampling pool: node k appears deg(k) times
    pool = [n for e in edges for n in e]
    for v in range(m + 1, V):
        targets = set()
        while len(targets) < m:
            targets.add(pool[rng.randint(0, len(pool))])
        for t in targets:
            edges.append((v, t))
            pool.append(v)
            pool.append(t)
    return _sym(V, edges)


def grid(side: int = 32) -> np.ndarray:
    """side × side 4-connected mesh (the classic data-center/NoC layout);
    side=32 -> 1024 nodes, 1984 undirected links."""
    V = side * side
    edges = []
    for i in range(side):
        for j in range(side):
            u = i * side + j
            if j + 1 < side:
                edges.append((u, u + 1))
            if i + 1 < side:
                edges.append((u, u + side))
    return _sym(V, edges)


TOPOLOGIES = {
    "connected_er": connected_er,
    "balanced_tree": balanced_tree,
    "fog": fog,
    "abilene": abilene,
    "lhc": lhc,
    "geant": geant,
    "small_world": small_world,
    "barabasi_albert": barabasi_albert,
    "grid": grid,
}
