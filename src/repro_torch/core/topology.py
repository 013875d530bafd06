"""Communication graphs and mixing matrices (counterpart of
``repro/core/topology.py``; numpy only, kept as the port's own copy because
the port imports nothing of ``repro``).

The theory needs a connected graph with a symmetric doubly-stochastic mixing
matrix W whose spectral gap is delta = 1 - |lambda_2(W)| > 0, and derives the
consensus stepsize gamma* of Lemma 6:

    gamma* = 2 delta omega / (64 delta + delta^2 + 16 beta^2
                              + 8 delta beta^2 - 16 delta omega),
    beta   = max_i (1 - lambda_i(W)) = ||W - I||_2.

Graphs: ring, 2-D torus, complete, and random regular expanders; weights:
uniform (1/(deg_max+1)) or Metropolis-Hastings. Time-varying plans
(:class:`GossipPlan`: random perfect matchings, edge-sampled subgraphs of a
base graph, a round-robin cycle over a graph list) need each round's W_r
symmetric doubly stochastic and the sequence connected on average:
``delta_eff`` is the gap of the round-averaged matrix and gamma* the worst
case over the support.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def ring_adjacency(n: int) -> np.ndarray:
    a = np.zeros((n, n))
    if n == 1:
        return a
    for i in range(n):
        a[i, (i + 1) % n] = 1
        a[i, (i - 1) % n] = 1
    if n == 2:
        a = np.minimum(a, 1)
    return a


def torus2d_adjacency(rows: int, cols: int) -> np.ndarray:
    n = rows * cols
    a = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                if j != i:
                    a[i, j] = 1
    return a


def complete_adjacency(n: int) -> np.ndarray:
    return np.ones((n, n)) - np.eye(n)


def matching_pairs(order: np.ndarray) -> Iterator[Tuple[np.intp, np.intp]]:
    """Pair up a permuted node order into a matching: ``(order[0],
    order[1]), (order[2], order[3]), ...``; for odd length the last node is
    left out."""
    return zip(order[0::2], order[1::2], strict=False)


def _try_regular(n: int, deg: int,
                 rng: np.random.Generator) -> Optional[np.ndarray]:
    """One rejection-sampling attempt at a deg-regular simple graph: deg//2
    random Hamiltonian cycles plus, for odd deg, one random perfect matching.
    Collisions between factors reject the attempt (the caller retries)."""
    a = np.zeros((n, n))
    for _ in range(deg // 2):
        order = rng.permutation(n)
        for i in range(n):
            u, v = order[i], order[(i + 1) % n]
            if u == v or a[u, v]:
                return None
            a[u, v] = a[v, u] = 1
    if deg % 2 == 1:
        for i, j in matching_pairs(rng.permutation(n)):
            if a[i, j]:
                return None
            a[i, j] = a[j, i] = 1
    return a


def random_regular_adjacency(n: int, deg: int, seed: int = 0) -> np.ndarray:
    """Random deg-regular graph (an expander with high probability). Dense
    graphs (deg > (n-1)/2) are sampled as the complement of an
    (n-1-deg)-regular graph, where rejection sampling terminates."""
    if not 0 < deg < n:
        raise ValueError(f"need 0 < deg < n, got deg={deg}, n={n}")
    if (n * deg) % 2 != 0:
        raise ValueError(
            f"no {deg}-regular graph on {n} nodes exists: n*deg must be even "
            f"(odd degree needs an even node count)")
    rng = np.random.default_rng(seed)
    co_deg = n - 1 - deg
    for _ in range(200):
        if co_deg < deg:
            co = (_try_regular(n, co_deg, rng) if co_deg
                  else np.zeros((n, n)))
            a = None if co is None else complete_adjacency(n) - co
        else:
            a = _try_regular(n, deg, rng)
        if a is not None and _connected(a):
            return a
    raise RuntimeError(
        f"failed to sample a connected {deg}-regular graph on {n} nodes "
        f"after 200 attempts")


def _connected(a: np.ndarray) -> bool:
    n = a.shape[0]
    seen = {0}
    stack = [0]
    while stack:
        i = stack.pop()
        for j in np.nonzero(a[i])[0]:
            if j not in seen:
                seen.add(int(j))
                stack.append(int(j))
    return len(seen) == n


def uniform_mixing(adj: np.ndarray) -> np.ndarray:
    """W = I - L/(max_deg+1): uniform neighbor weight 1/(deg_max+1)."""
    deg = adj.sum(1)
    dmax = deg.max() if adj.size else 0.0
    w = adj / (dmax + 1.0)
    np.fill_diagonal(w, 1.0 - w.sum(1))
    return w


def metropolis_mixing(adj: np.ndarray) -> np.ndarray:
    n = adj.shape[0]
    deg = adj.sum(1)
    w = np.zeros((n, n))
    for i in range(n):
        for j in np.nonzero(adj[i])[0]:
            w[i, j] = 1.0 / (max(deg[i], deg[j]) + 1.0)
    np.fill_diagonal(w, 1.0 - w.sum(1))
    return w


def _lemma6_gamma(delta: float, beta: float, omega: float) -> float:
    """Lemma 6 consensus stepsize from (delta, beta, omega)."""
    denom = (64 * delta + delta * delta + 16 * beta * beta
             + 8 * delta * beta * beta - 16 * delta * omega)
    return 2.0 * delta * omega / denom


@dataclasses.dataclass(frozen=True)
class Topology:
    """A mixing matrix plus the spectral quantities the theory needs."""

    w: np.ndarray            # (n, n) symmetric doubly stochastic
    name: str = "ring"

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def eigenvalues(self) -> np.ndarray:
        return np.sort(np.linalg.eigvalsh(self.w))[::-1]

    @property
    def delta(self) -> float:
        """Spectral gap 1 - |lambda_2|."""
        ev = self.eigenvalues
        if len(ev) == 1:
            return 1.0
        lam2 = max(abs(ev[1]), abs(ev[-1]))
        return float(1.0 - lam2)

    @property
    def beta(self) -> float:
        """||W - I||_2 = max_i (1 - lambda_i)."""
        return float(1.0 - self.eigenvalues[-1])

    def gamma_star(self, omega: float) -> float:
        """Consensus stepsize of Lemma 6."""
        return _lemma6_gamma(self.delta, self.beta, omega)

    def p(self, omega: float) -> float:
        """``gamma_star(omega) * delta / 8``, the rate of Theorems 1-2."""
        return self.gamma_star(omega) * self.delta / 8.0

    @property
    def degrees(self) -> np.ndarray:
        """Neighbor count per node, excluding self whatever the diagonal
        holds: the one degree both engines charge bits with."""
        return (self.w > 0).sum(1) - (np.diagonal(self.w) > 0)

    def neighbors(self, i: int) -> np.ndarray:
        """Node ``i``'s neighbours (positive weight, itself excluded)."""
        mask = self.w[i] > 0
        mask[i] = False
        return np.nonzero(mask)[0]

    def validate(self, atol: float = 1e-10, *,
                 require_connected: bool = True) -> None:
        """Raise ``ValueError`` on an invalid mixing matrix, or a
        disconnected one unless ``require_connected=False`` (a single round
        of a time-varying plan, e.g. one matching)."""
        w, name = self.w, self.name
        if not np.allclose(w, w.T, atol=atol):
            raise ValueError(
                f"mixing matrix {name!r} is not symmetric: max asymmetry "
                f"{np.abs(w - w.T).max():.3e} exceeds atol={atol}")
        if not np.allclose(w.sum(0), 1.0, atol=atol):
            raise ValueError(
                f"mixing matrix {name!r} is not doubly stochastic: column "
                f"sums range [{w.sum(0).min():.6f}, {w.sum(0).max():.6f}]")
        if not np.all(w >= -atol):
            raise ValueError(
                f"mixing matrix {name!r} has negative weights (min "
                f"{w.min():.3e})")
        if require_connected and not self.delta > 0:
            raise ValueError(
                f"graph {name!r} is disconnected (spectral gap delta = "
                f"{self.delta:.3e} <= 0)")


def make_topology(kind: str, n: int, *, deg: int = 4, seed: int = 0,
                  mixing: str = "uniform") -> Topology:
    if kind == "ring":
        adj = ring_adjacency(n)
    elif kind == "torus2d":
        r = int(np.sqrt(n))
        if r * r != n:
            raise ValueError(
                f"torus2d needs a square node count, got n={n} "
                f"(nearest squares: {r * r} and {(r + 1) * (r + 1)})")
        adj = torus2d_adjacency(r, r)
    elif kind == "complete":
        adj = complete_adjacency(n)
    elif kind == "expander":
        adj = random_regular_adjacency(n, deg, seed)
    else:
        raise ValueError(f"unknown topology {kind!r}")
    w = uniform_mixing(adj) if mixing == "uniform" else metropolis_mixing(adj)
    t = Topology(w=w, name=kind)
    t.validate()
    return t


def circulant_row(w: np.ndarray, atol: float = 1e-12) -> Optional[np.ndarray]:
    """First row ``c`` of ``w`` if it is circulant (w[i, j] == c[(j-i) % n]),
    else ``None``. A circulant W lets the engine compute ``W x - x`` as a
    few row rolls instead of a dense product."""
    w = np.asarray(w)
    c = w[0]
    for i in range(1, w.shape[0]):
        if not np.allclose(w[i], np.roll(c, i), atol=atol):
            return None
    return c


@dataclasses.dataclass(frozen=True)
class GossipPlan:
    """A sequence of mixing matrices, one per sync round: round ``r``
    gossips over ``ws[r % R]``; ``R == 1`` is a static plan. ``delta_eff``
    is the spectral gap of the round average (one matching alone is
    disconnected; the sequence mixes) and ``gamma_star`` the Lemma-6 value
    at ``(delta_eff, beta_r)``, minimized over the rounds."""

    ws: np.ndarray           # (R, n, n)
    name: str = "static"

    def __post_init__(self):
        ws = np.asarray(self.ws, np.float64)
        if ws.ndim != 3 or ws.shape[1] != ws.shape[2] or ws.shape[0] < 1:
            raise ValueError(
                f"GossipPlan.ws must be a (R >= 1, n, n) stack, got shape "
                f"{ws.shape}")
        object.__setattr__(self, "ws", ws)

    @classmethod
    def from_topology(cls, topology: Topology) -> "GossipPlan":
        """Static plan: the same mixing matrix every sync round."""
        return cls(ws=topology.w[None], name=topology.name)

    @classmethod
    def cycle(cls, topologies: Sequence[Topology]) -> "GossipPlan":
        """Round-robin over an explicit graph list."""
        tops = list(topologies)
        if not tops:
            raise ValueError("GossipPlan.cycle needs at least one topology")
        sizes = {t.n for t in tops}
        if len(sizes) != 1:
            raise ValueError(
                f"GossipPlan.cycle topologies disagree on node count: "
                f"{sorted(sizes)}")
        plan = cls(ws=np.stack([t.w for t in tops]),
                   name="cycle(" + ",".join(t.name for t in tops) + ")")
        plan.validate()
        return plan

    @classmethod
    def matchings(cls, n: int, rounds: int = 8, seed: int = 0) -> "GossipPlan":
        """Random perfect matchings: each round pairs the ``n`` nodes (n
        even) at random and matched pairs average with weight 1/2."""
        if n < 2 or n % 2:
            raise ValueError(
                f"random perfect matchings need an even node count >= 2, "
                f"got n={n}")
        if rounds < 1:
            raise ValueError(f"need rounds >= 1, got {rounds}")
        rng = np.random.default_rng(seed)
        ws = []
        for _ in range(rounds):
            w = np.eye(n)
            for i, j in matching_pairs(rng.permutation(n)):
                w[i, i] = w[j, j] = 0.5
                w[i, j] = w[j, i] = 0.5
            ws.append(w)
        plan = cls(ws=np.stack(ws), name=f"matchings(R={rounds})")
        plan.validate()
        return plan

    @classmethod
    def edge_sampled(cls, base: Topology, rounds: int = 8, p: float = 0.5,
                     seed: int = 0, mixing: str = "uniform") -> "GossipPlan":
        """Per-round random subgraphs of ``base``: each edge is kept with
        probability ``p`` each round and the sampled adjacency gets fresh
        ``mixing`` weights; a node isolated in a round keeps its iterate."""
        if not 0.0 < p <= 1.0:
            raise ValueError(f"edge keep-probability must be in (0, 1], "
                             f"got {p}")
        if rounds < 1:
            raise ValueError(f"need rounds >= 1, got {rounds}")
        n = base.n
        adj = (base.w > 0).astype(np.float64)
        np.fill_diagonal(adj, 0.0)
        mix = uniform_mixing if mixing == "uniform" else metropolis_mixing
        rng = np.random.default_rng(seed)
        ws = []
        for _ in range(rounds):
            keep = np.triu(rng.random((n, n)) < p, k=1)
            ws.append(mix(adj * (keep | keep.T)))
        plan = cls(ws=np.stack(ws),
                   name=f"edges({base.name},p={p},R={rounds})")
        plan.validate()
        return plan

    @property
    def n(self) -> int:
        return self.ws.shape[1]

    @property
    def R(self) -> int:
        """Support size: round r uses ws[r % R]."""
        return self.ws.shape[0]

    @property
    def is_static(self) -> bool:
        return self.R == 1

    def round_topology(self, r: int) -> Topology:
        r = r % self.R
        return Topology(w=self.ws[r], name=f"{self.name}[{r}]")

    @property
    def w_bar(self) -> np.ndarray:
        return self.ws.mean(0)

    @property
    def delta_eff(self) -> float:
        return Topology(w=self.w_bar, name=f"{self.name}:avg").delta

    @property
    def beta_max(self) -> float:
        """Worst-case ``||W_r - I||_2`` over the support."""
        return max(self.round_topology(r).beta for r in range(self.R))

    @property
    def degrees(self) -> np.ndarray:
        """(R, n) per-round neighbor counts."""
        return np.stack([self.round_topology(r).degrees
                         for r in range(self.R)])

    def gamma_star(self, omega: float) -> float:
        d = self.delta_eff
        return min(_lemma6_gamma(d, self.round_topology(r).beta, omega)
                   for r in range(self.R))

    def p(self, omega: float) -> float:
        """``gamma_star(omega) * delta_eff / 8``."""
        return self.gamma_star(omega) * self.delta_eff / 8.0

    def validate(self, atol: float = 1e-10) -> None:
        """Every round symmetric doubly stochastic; connected on average."""
        for r in range(self.R):
            self.round_topology(r).validate(atol=atol,
                                            require_connected=False)
        if not self.delta_eff > 0:
            raise ValueError(
                f"gossip plan {self.name!r} is disconnected in expectation "
                f"(delta_eff = {self.delta_eff:.3e} <= 0): the round-averaged "
                f"graph must be connected for consensus to form")


def make_plan(kind: str = "ring", n: int = 8, *, deg: int = 4, seed: int = 0,
              mixing: str = "uniform", dynamic: str = "none", rounds: int = 8,
              edge_frac: float = 0.5) -> GossipPlan:
    """Every static or time-varying plan. ``dynamic``: ``"none"`` the
    static ``make_topology(kind, n, ...)``; ``"matchings"`` random perfect
    matchings (``kind`` ignored); ``"edges"`` edge-sampled subgraphs of the
    ``kind`` graph, each edge kept w.p. ``edge_frac``; ``"cycle"`` a
    round-robin over ``rounds`` graphs of ``kind`` built with seeds
    ``seed .. seed+rounds-1``."""
    if dynamic in ("none", "static", ""):
        return GossipPlan.from_topology(
            make_topology(kind, n, deg=deg, seed=seed, mixing=mixing))
    if dynamic == "matchings":
        return GossipPlan.matchings(n, rounds=rounds, seed=seed)
    if dynamic == "edges":
        base = make_topology(kind, n, deg=deg, seed=seed, mixing=mixing)
        return GossipPlan.edge_sampled(base, rounds=rounds, p=edge_frac,
                                       seed=seed, mixing=mixing)
    if dynamic == "cycle":
        return GossipPlan.cycle(
            [make_topology(kind, n, deg=deg, seed=seed + r, mixing=mixing)
             for r in range(rounds)])
    raise ValueError(
        f"unknown dynamic plan {dynamic!r}; have none|matchings|edges|cycle")
