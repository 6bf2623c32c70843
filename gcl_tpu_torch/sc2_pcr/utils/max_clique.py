"""Maximum-clique seed selection (a copy of
scripts/SC2_PCR/utils/max_clique.py; the reference wraps a ctypes
libpmc.so that is not shipped, and no main path uses it). A numpy
greedy + local-search clique finder keeps the capability available."""
import numpy as np


def max_clique(adj: np.ndarray, iters: int = 8) -> np.ndarray:
    """Greedy max clique over a boolean adjacency matrix; returns member
    indices. Not exact (the problem is NP-hard) — degeneracy-ordered
    greedy with restarts, adequate for seed selection."""
    n = adj.shape[0]
    adj = adj.astype(bool) & ~np.eye(n, dtype=bool)
    best = np.array([], dtype=np.int64)
    deg = adj.sum(1)
    order = np.argsort(-deg)
    rng = np.random.RandomState(0)
    for it in range(iters):
        start = order[it % n] if it < n else rng.randint(n)
        clique = [start]
        cand = np.where(adj[start])[0]
        while len(cand):
            scores = adj[np.ix_(cand, cand)].sum(1)
            pick = cand[np.argmax(scores)]
            clique.append(pick)
            cand = cand[adj[pick, cand]]
        if len(clique) > len(best):
            best = np.asarray(clique)
    return best
