"""Topology abstraction and the TA-MoE dispatch-pattern solver (the
counterpart of ``repro/core/topology.py``, numpy only).

* tree topologies written as nested lists (paper Fig. 2), e.g. ``[[2, 2],
  [2]]``, and ring topologies (Fig. 2(b)), for planning only: no world
  is built on a ring;
* the alpha-beta communication model and Eq. (5) level smoothing;
* the closed-form near-optimal dispatch of Eq. (7) and its per-level
  capacity ratios;
* asymmetric -> symmetric merging (paper §4.2).

The link constants below are the reference's, unchanged: they decide the
capacity plan, and both packages must agree on it.  A link ladder for the
card's own interconnect comes with the communication-model slice.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

import numpy as np

Nested = Sequence  # nested list of ints (leaf node sizes) or deeper lists


# ---------------------------------------------------------------------------
# Tree topology
# ---------------------------------------------------------------------------


def _leaves_per_subtree(spec) -> int:
    if isinstance(spec, int):
        return spec
    return sum(_leaves_per_subtree(s) for s in spec)


def _depth(spec) -> int:
    """Number of switch layers in the spec (an int leaf-group = 1 switch)."""
    if isinstance(spec, int):
        return 1
    return 1 + max(_depth(s) for s in spec)


def _assign_paths(spec, prefix=()):
    """Yield (device_index_order, path) pairs; path = tuple of child indices."""
    if isinstance(spec, int):
        for d in range(spec):
            yield prefix + (d,)
        return
    for ci, child in enumerate(spec):
        yield from _assign_paths(child, prefix + (ci,))


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """A hierarchical network topology (paper Fig. 2 (a), (c), (d)).

    ``spec`` is the nested-list notation of the paper.  Devices are numbered
    depth-first.  ``level(i, j)`` is the number of switches on the shortest
    path between devices i and j (0 = same device), i.e. the paper's
    ``G^i_t`` grouping index.
    """

    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "_paths", tuple(_assign_paths(self.spec)))

    @property
    def num_devices(self) -> int:
        return len(self._paths)

    @property
    def num_levels(self) -> int:
        """Levels run 0 (self) .. depth (across the root switch)."""
        return _depth(self.spec) + 1

    def level(self, i: int, j: int) -> int:
        """Switches crossed between devices i and j (0 when i == j)."""
        if i == j:
            return 0
        pi, pj = self._paths[i], self._paths[j]
        # pad to equal length (asymmetric trees give unequal path lengths)
        n = max(len(pi), len(pj))
        pi = (0,) * (n - len(pi)) + tuple(pi)
        pj = (0,) * (n - len(pj)) + tuple(pj)
        # find first differing component from the root
        for k in range(n):
            if pi[k] != pj[k]:
                return n - k
        return 0

    def level_matrix(self) -> np.ndarray:
        P = self.num_devices
        m = np.zeros((P, P), dtype=np.int64)
        for i in range(P):
            for j in range(P):
                m[i, j] = self.level(i, j)
        return m

    def level_sizes(self, i: int = 0) -> np.ndarray:
        """n_l = |G^i_l| for each level l (including level 0 = self)."""
        lm = self.level_matrix()[i]
        return np.bincount(lm, minlength=self.num_levels)

    def is_symmetric(self) -> bool:
        """True iff every device sees identical level-group sizes."""
        lm = self.level_matrix()
        counts = [tuple(np.bincount(lm[i], minlength=self.num_levels))
                  for i in range(self.num_devices)]
        return len(set(counts)) == 1


@dataclasses.dataclass(frozen=True)
class RingTopology:
    """Ring topology (paper Fig. 2(b)): P devices, level(i, j) = hop count.

    "The ring topology also shows a hierarchical characteristic and the
    solution for ring topology has the same pattern as symmetric trees"
    (§4.2): every device sees the same per-hop group sizes, so Eq. (7)
    applies unchanged with per-hop beta values (traffic between
    non-adjacent devices hops through intermediates; the per-hop beta
    encodes the slowest link on the path).
    """

    num_devices_: int

    @property
    def num_devices(self) -> int:
        return self.num_devices_

    @property
    def num_levels(self) -> int:
        return self.num_devices_ // 2 + 1

    def level(self, i: int, j: int) -> int:
        d = abs(i - j)
        return min(d, self.num_devices_ - d)

    def level_matrix(self) -> np.ndarray:
        P = self.num_devices_
        i = np.arange(P)
        d = np.abs(i[:, None] - i[None, :])
        return np.minimum(d, P - d)

    def level_sizes(self, i: int = 0) -> np.ndarray:
        lm = self.level_matrix()[i]
        return np.bincount(lm, minlength=self.num_levels)

    def is_symmetric(self) -> bool:
        return True


def symmetrize(topo: TreeTopology) -> TreeTopology:
    """Merge an asymmetric tree into the closest symmetric structure.

    Paper §4.2: "[[2,2],[2]] in figure 2(d) can be merged as symmetric
    structure [[2,2,2]]" — separate nodes are merged into the close symmetric
    sub-trees.  We implement this by collapsing the tree to its innermost
    leaf-groups and re-attaching all of them under a single root switch,
    equalizing group sizes to the most common leaf-group arity (splitting
    larger groups / merging stragglers as needed).
    """
    if topo.is_symmetric():
        return topo

    def leaf_groups(spec):
        if isinstance(spec, int):
            return [spec]
        out = []
        for s in spec:
            out.extend(leaf_groups(s))
        return out

    groups = leaf_groups(topo.spec)
    total = sum(groups)
    # most common group arity
    arities = {}
    for g in groups:
        arities[g] = arities.get(g, 0) + 1
    arity = max(sorted(arities), key=lambda a: arities[a])
    if total % arity != 0:  # fall back to gcd so every device is kept
        arity = math.gcd(arity, total)
        arity = max(arity, 1)
    n_groups = total // arity
    return TreeTopology(tuple([arity] * n_groups))


# ---------------------------------------------------------------------------
# alpha-beta model + Eq. (5) smoothing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommModel:
    """alpha-beta cost model over a TreeTopology or a RingTopology.

    ``alpha[l]`` (seconds) and ``beta[l]`` (seconds/byte) are per-level
    constants — either supplied directly (hardware datasheet) or produced by
    :func:`smooth_profile` from a profiled per-pair matrix (paper Eq. 5).
    """

    topo: TreeTopology
    alpha: tuple  # per level, seconds
    beta: tuple   # per level, seconds per byte

    def __post_init__(self):
        assert len(self.alpha) == self.topo.num_levels, (
            len(self.alpha), self.topo.num_levels)
        assert len(self.beta) == self.topo.num_levels

    def alpha_beta_matrices(self):
        """Hierarchical matrices of Eq. (5): alpha_hat[i,j], beta_hat[i,j]."""
        lm = self.topo.level_matrix()
        a = np.asarray(self.alpha)[lm]
        b = np.asarray(self.beta)[lm]
        return a, b

    def p2p_time(self, i: int, j: int, nbytes: float) -> float:
        l = self.topo.level(i, j)
        return self.alpha[l] + self.beta[l] * nbytes


def smooth_profile(topo: TreeTopology, alpha_ij: np.ndarray,
                   beta_ij: np.ndarray) -> CommModel:
    """Eq. (5): average the profiled per-pair alpha/beta within each level.

    alpha_l = sum_{i<j, j in G_l^i} alpha_ij / #pairs(l); likewise beta.
    This "precisely characterizes the underlying topology and eliminates the
    noise of profiling" (paper §4.2).
    """
    lm = topo.level_matrix()
    L = topo.num_levels
    alpha, beta = [], []
    for l in range(L):
        if l == 0:
            mask = np.eye(topo.num_devices, dtype=bool)
        else:
            mask = np.triu(lm == l, k=1)
        if mask.sum() == 0:
            alpha.append(0.0)
            beta.append(np.inf)
            continue
        alpha.append(float(alpha_ij[mask].mean()))
        beta.append(float(beta_ij[mask].mean()))
    return CommModel(topo=topo, alpha=tuple(alpha), beta=tuple(beta))


# ---------------------------------------------------------------------------
# Eq. (7): target dispatch pattern
# ---------------------------------------------------------------------------


def target_dispatch(model: CommModel, tokens_sent: float,
                    experts_per_device: int = 1) -> np.ndarray:
    """Near-optimal dispatch chunk sizes c_hat[i, e] of Eq. (7).

    ``tokens_sent`` is k*S — the number of (token, expert) assignments each
    device emits per step.  Returns c_hat with shape [P, N] where
    N = P * experts_per_device; c_hat[i, e] is the number of tokens device i
    should send to expert e.

        c_hat[i,e] = k*S / (E * sum_j 1/beta_hat[i,j]) * 1/beta_hat[i, dev(e)]

    Row sums equal k*S exactly (constraint Eq. 3).  On symmetric topologies
    column sums equal k*S*P/N (constraint Eq. 4) by symmetry.
    """
    topo = model.topo
    if not topo.is_symmetric():
        # paper §4.2: merge asymmetric topologies into the closest symmetric
        # structure, then optimize the lower bound on that structure.
        sym = symmetrize(topo)
        model = CommModel(topo=sym, alpha=model.alpha[: sym.num_levels],
                          beta=model.beta[: sym.num_levels])
        topo = sym
    P = topo.num_devices
    E = experts_per_device
    N = P * E
    _, beta_hat = model.alpha_beta_matrices()
    inv = 1.0 / beta_hat  # [P, P]
    denom = inv.sum(axis=1, keepdims=True)  # sum_j 1/beta_hat[i,j]
    c_dev = tokens_sent * inv / denom  # [P, P] tokens from i to device j
    # split evenly across the E experts of each device
    c = np.repeat(c_dev / E, E, axis=1)  # [P, N]
    return c


def per_level_ratios(model: CommModel) -> np.ndarray:
    """TA-MoE capacity multipliers per level (vs. even dispatch).

    ratio[l] = c_hat(level l) / c_even, with c_even = k*S/N.  Derived from
    Eq. (7): ratio[l] = P * (1/beta_l) / sum_l' n_l'/beta_l'.  These feed the
    per-level static capacities of the hierarchical all-to-all
    (``core/capacity.py``).
    """
    topo = model.topo
    if not topo.is_symmetric():
        sym = symmetrize(topo)
        model = CommModel(topo=sym, alpha=model.alpha[: sym.num_levels],
                          beta=model.beta[: sym.num_levels])
        topo = sym
    n = topo.level_sizes(0).astype(np.float64)  # [L]
    beta = np.asarray(model.beta, dtype=np.float64)
    inv = np.where(n > 0, 1.0 / beta, 0.0)
    denom = float((n * inv).sum())
    P = topo.num_devices
    return P * inv / denom  # [L]


def penalty_weights(c_hat_row: np.ndarray, norm: str = "sum") -> np.ndarray:
    """p_i = Norm(1 / c_hat_i) of Eq. (8) for one source device.

    ``norm='sum'`` normalizes to mean 1 so the topology loss keeps the
    magnitude of the classic load-balance loss; ``norm='softmax'`` is the
    paper's suggested alternative that enlarges slow-link penalties.
    """
    inv = 1.0 / np.maximum(c_hat_row, 1e-12)
    if norm == "sum":
        return inv / inv.mean()
    if norm == "softmax":
        z = inv / inv.mean()
        e = np.exp(z - z.max())
        p = e / e.sum()
        return p / p.mean()
    raise ValueError(f"unknown norm {norm!r}")


# ---------------------------------------------------------------------------
# default link ladder (the reference's constants)
# ---------------------------------------------------------------------------

# The reference's link constants (its TPU target).  They only set the
# ratios of Eq. (7); the port keeps them so both packages plan alike.
ICI_BW = 50e9          # bytes/s per link, intra-pod
DCI_BW = 6.25e9        # bytes/s, inter-pod data-center interconnect
NODE_BW = 12.5e9       # bytes/s, intra-pod inter-node DCN (3-tier meshes)
LOCAL_BW = 819e9       # HBM-speed "self" transfers
ICI_ALPHA = 1e-6       # s
DCI_ALPHA = 10e-6      # s
NODE_ALPHA = 5e-6      # s, intra-pod DCN hop


def tpu_topology(num_pods: int, devices_per_pod: int) -> CommModel:
    """The production EP topology: pods of devices over ICI, pods over DCI.

    Levels: 0 = self, 1 = intra-pod (ICI), 2 = inter-pod (DCI).  The self
    level is deliberately folded into ICI bandwidth (beta_0 = beta_ICI):
    this is exactly the paper's Eq. (5) smoothing rationale — an extreme
    beta_0 (HBM) would starve remote experts of data ("expert isolation",
    §4.2), and equal-split all_to_all keeps the self chunk on-device anyway
    so its capacity must match the intra-pod peers'.
    """
    if num_pods == 1:
        topo = TreeTopology(devices_per_pod)  # flat: one switch level
        return CommModel(topo=topo,
                         alpha=(0.0, ICI_ALPHA),
                         beta=(1.0 / ICI_BW, 1.0 / ICI_BW))
    topo = TreeTopology(tuple([devices_per_pod] * num_pods))
    return CommModel(topo=topo,
                     alpha=(0.0, ICI_ALPHA, DCI_ALPHA),
                     beta=(1.0 / ICI_BW, 1.0 / ICI_BW, 1.0 / DCI_BW))


def nested_spec(axis_sizes: Sequence):
    """Symmetric TreeTopology spec for an N-axis mesh hierarchy.

    ``axis_sizes`` are outermost-first, e.g. ``(2, 2, 2)`` (pod x node x
    data) gives the paper-notation spec ``((2, 2), (2, 2))`` — the nested
    [[2, 2], [2, 2]] of Fig. 2.  A single axis yields the flat int spec.
    """
    sizes = tuple(int(s) for s in axis_sizes)
    if not sizes:
        raise ValueError("axis_sizes must be non-empty")
    spec = sizes[-1]
    for s in reversed(sizes[:-1]):
        spec = (spec,) * s
    return spec


def axis_sizes_from_spec(spec) -> tuple:
    """Per-axis sizes (outermost-first) of a *symmetric* nested spec.

    Inverse of :func:`nested_spec`: ``[[2, 2], [2, 2]] -> (2, 2, 2)``.
    Asymmetric specs are merged first (paper §4.2) so every spec yields a
    concrete mesh hierarchy.
    """
    def _tup(s):
        return s if isinstance(s, int) else tuple(_tup(c) for c in s)

    topo = TreeTopology(_tup(spec))
    if not topo.is_symmetric():
        topo = symmetrize(topo)
    sizes = []
    node = topo.spec
    while not isinstance(node, int):
        sizes.append(len(node))
        node = node[0]
    sizes.append(node)
    return tuple(sizes)


def tree_topology_nd(axis_sizes: Sequence, *, alpha=None,
                     beta=None) -> CommModel:
    """alpha-beta CommModel for an N-axis hierarchical mesh.

    ``axis_sizes`` are outermost-first (``(pods, nodes, data)``).  For one
    or two axes this is exactly :func:`tpu_topology` (byte-identical plans
    for existing 2-level configs); deeper hierarchies get the default
    bandwidth ladder innermost ICI -> intermediate DCN (``NODE_BW``) ->
    outermost DCI, with the self level folded into the innermost link as
    always (Eq. 5 smoothing rationale; see :func:`tpu_topology`).
    Explicit per-level ``alpha``/``beta`` tuples (length ``n_axes + 1``,
    level 0 = self) override the ladder.
    """
    sizes = tuple(int(s) for s in axis_sizes)
    n = len(sizes)
    if alpha is None and beta is None and n <= 2:
        if n == 1:
            return tpu_topology(1, sizes[0])
        return tpu_topology(sizes[0], sizes[1])
    topo = TreeTopology(nested_spec(sizes))
    if beta is None:
        # level 1 = innermost (ICI, with self folded in), top level = DCI,
        # everything between = intra-pod DCN
        beta = (1.0 / ICI_BW, 1.0 / ICI_BW) \
            + (1.0 / NODE_BW,) * (n - 2) + (1.0 / DCI_BW,)
    if alpha is None:
        alpha = (0.0, ICI_ALPHA) + (NODE_ALPHA,) * (n - 2) + (DCI_ALPHA,)
    return CommModel(topo=topo, alpha=tuple(alpha), beta=tuple(beta))
