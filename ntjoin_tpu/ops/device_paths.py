"""Device-resident path-extraction passes (SURVEY §2.2(c)).

Completes the data-parallel replacement of the reference's per-component
``multiprocessing.Pool`` loop (``bin/ntjoin.py:137-176``): the escalating
branch-edge filter and the simple-chain walk — the two passes that scale
with the graph — run as XLA programs over the whole graph at once.

* :func:`escalate_filter_device` — the per-component lockstep threshold
  escalation (reference ``filter_graph`` + while loop,
  ``ntjoin.py:70-78,143-146``) as a ``lax.while_loop`` over masked
  scatter-add degree passes.  Bit-identical alive mask to the host
  ``graph.paths.escalating_branch_filter``.

* :func:`chain_ranks_device` — ALL simple chains walked at once by
  pointer jumping over directed half-edges: half-edge ``2*u + j`` points
  from ``u`` via its ``j``-th neighbour slot; its successor at ``v`` is
  the slot that does not return to ``u``.  log2(max chain length)
  doubling rounds compute, per half-edge, the terminal it reaches and
  the node count remaining — the host then slices per chain (the walked
  order of chain ``s..t`` = half-edges pointing at ``t``, by descending
  remaining-count).  Replaces the sequential per-chain native walk with
  O(log n) data-parallel rounds.

Both are exact; the host implementations remain the byte-equality oracle
(``tests/test_device_paths.py``).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_I32 = jnp.int32


def _bucket(n: int, lo: int = 1024) -> int:
    size = lo
    while size < n:
        size *= 2
    return size


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def _escalate_jit(src, dst, weight, alive, comp, n_nodes: int,
                  n_min, max_weight):
    """One while_loop: threshold escalation until every component linear."""

    def comp_done(alive):
        a = alive.astype(_I32)
        deg = jnp.zeros(n_nodes, _I32).at[src].add(a).at[dst].add(a)
        comp_max = jnp.zeros(n_nodes, _I32).at[comp].max(deg)
        return deg, comp_max[comp] <= 2  # per-node done flag of its comp

    def cond(state):
        _, thr, done_all = state
        return (~done_all) & (thr <= max_weight)

    def body(state):
        alive, thr, _ = state
        deg, done_n = comp_done(alive)
        branch = deg > 2
        rm = (
            alive
            & ~done_n[src]
            & (weight < thr)
            & (branch[src] | branch[dst])
        )
        alive = alive & ~rm
        _, done_n2 = comp_done(alive)
        return alive, thr + jnp.float32(1.0), jnp.all(done_n2)

    _, done0 = comp_done(alive)
    state = (alive, jnp.asarray(n_min, jnp.float32), jnp.all(done0))
    alive, _, _ = jax.lax.while_loop(cond, body, state)
    return alive


def weights_exact_f32(weight: np.ndarray, n_min: float,
                      max_weight: float) -> bool:
    """Whether the device filter's float32 compares are exact.

    The kernel compares weights and thresholds in float32 where the host
    pass compares float64: a weight that float32 cannot hold (e.g.
    reference_weights='0.1 0.3') could flip a ``weight < threshold``
    verdict, and the +1.0 threshold walk must stay in float32's exact
    integer range.
    """
    w64 = np.asarray(weight, dtype=np.float64)
    return (
        abs(float(n_min)) <= 2.0**23  # +1.0 walk stays f32-exact, incl. x.5
        and abs(float(max_weight)) <= 2.0**23
        and float(np.float32(n_min)) == float(n_min)
        and float(np.float32(max_weight)) == float(max_weight)
        and bool(np.all(w64.astype(np.float32).astype(np.float64) == w64))
    )


def escalate_filter_device(graph, comp: np.ndarray, n_min: float,
                           max_weight: float) -> np.ndarray:
    """Device escalating branch filter; returns the new alive mask.

    Same in-place contract as ``graph.paths.escalating_branch_filter``:
    edges below the escalating threshold incident to a branch node of a
    not-yet-linear component die, one threshold step per iteration.
    """
    if not weights_exact_f32(graph.weight, n_min, max_weight):
        raise ValueError(
            "edge weights/threshold not exactly representable in float32; "
            "host escalating filter required for bit-exact results"
        )
    m = graph.src.shape[0]
    cap = _bucket(max(m, 1))
    pad = cap - m
    n_cap = _bucket(max(graph.num_nodes, 1))  # bucketed: bounded recompiles

    def p(x, fill):
        return np.concatenate([x, np.full(pad, fill, x.dtype)]) if pad else x

    comp_p = np.zeros(n_cap, np.int32)
    comp_p[: comp.shape[0]] = comp  # pad nodes: comp 0, degree 0 -> inert
    alive = np.asarray(
        _escalate_jit(
            jnp.asarray(p(graph.src.astype(np.int32), 0)),
            jnp.asarray(p(graph.dst.astype(np.int32), 0)),
            jnp.asarray(p(graph.weight.astype(np.float32), 0.0)),
            jnp.asarray(p(graph.alive, False)),
            jnp.asarray(comp_p),
            n_nodes=n_cap,
            n_min=np.float32(n_min),
            max_weight=np.float32(max_weight),
        )
    )
    return alive[:m]


@functools.partial(jax.jit, static_argnames=("rounds",))
def _rank_jit(n1, n2, rounds: int):
    """Pointer-jumping list ranking over directed half-edges.

    Half-edge h = 2*u + j points u -> nbr_j(u) (nbr_0 = n1, nbr_1 = n2).
    Returns (terminal, remain): the half-edge id this direction terminates
    with, and the number of nodes from u to the chain end inclusive of the
    terminal's head but exclusive of its v (i.e. remain = 1 on the last
    half-edge).  Dead slots (nbr = -1) are self-terminal with remain 0.
    """
    n = n1.shape[0]
    u = jnp.repeat(jnp.arange(n, dtype=_I32), 2)
    v = jnp.stack([n1, n2], axis=1).reshape(-1)
    live = v >= 0
    vs = jnp.maximum(v, 0)
    # successor half-edge at v: the slot not returning to u (tie: parallel
    # edges never survive the build; deg-1 v has its only slot in n1)
    succ = 2 * vs + jnp.where(n1[vs] != u, 0, 1)
    nxt_slot = jnp.where(succ % 2 == 0, n1[vs], n2[vs])
    terminal_here = ~live | (nxt_slot < 0)
    h = jnp.arange(2 * n, dtype=_I32)
    # two pointer chains (Wyllie): the NIL-style pointer drives rank
    # accumulation (each rank absorbed exactly once — a self-loop terminal
    # would be re-absorbed every round), the self-loop pointer converges to
    # the terminal's IDENTITY for grouping.  Cycles never terminate — their
    # remain is clamped (and never queried: sources exist only on chains).
    ptr_t = jnp.where(terminal_here, h, succ)
    ptr_r = jnp.where(terminal_here, -1, succ)
    remain = jnp.where(live, 1, 0).astype(_I32)

    def body(_, state):
        ptr_t, ptr_r, remain = state
        mask = ptr_r >= 0
        idx = jnp.maximum(ptr_r, 0)
        remain = jnp.minimum(
            remain + jnp.where(mask, remain[idx], 0), 1 << 30
        )
        ptr_r = jnp.where(mask, ptr_r[idx], -1)
        return ptr_t[ptr_t], ptr_r, remain

    ptr_t, _, remain = jax.lax.fori_loop(
        0, rounds, body, (ptr_t, ptr_r, remain)
    )
    return ptr_t, remain


def chain_ranks_device(
    n1: np.ndarray, n2: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(terminal, remain) per half-edge for all chains at once."""
    n = n1.shape[0]
    rounds = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    term, remain = _rank_jit(
        jnp.asarray(n1.astype(np.int32)), jnp.asarray(n2.astype(np.int32)),
        rounds=rounds,
    )
    return np.asarray(term), np.asarray(remain)


class RankWalker:
    """Per-source chain walks from one device ranking pass.

    Grouping by terminal happens once; ``walk(source)`` then returns the
    chain's (nodes, eids) exactly like the sequential native walk: nodes
    in walk order, the i-th eid joining nodes i and i+1.
    """

    def __init__(self, term, remain, n1, n2, e1, e2):
        self.term, self.remain = term, remain
        self.n1, self.n2 = n1, n2
        n = n1.shape[0]
        self.he_u = np.repeat(np.arange(n, dtype=np.int64), 2)
        self.he_e = np.stack(
            [e1.astype(np.int64), e2.astype(np.int64)], axis=1
        ).reshape(-1)
        # group half-edges by terminal (each chain direction = one group),
        # descending remain within a group = ascending walk order
        self.order = np.lexsort((-remain, term))
        term_s = term[self.order]
        starts = np.flatnonzero(
            np.concatenate([[True], term_s[1:] != term_s[:-1]])
        )
        self.bounds = np.append(starts, term_s.shape[0])
        self.group_of = {
            int(term_s[starts[i]]): i for i in range(starts.shape[0])
        }

    def walk(self, s: int) -> tuple[np.ndarray, np.ndarray]:
        h0 = 2 * int(s)  # deg-1 source: its only neighbour is in n1
        gi = self.group_of.get(int(self.term[h0]))
        if gi is None:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        grp = self.order[self.bounds[gi]: self.bounds[gi + 1]]
        nodes = self.he_u[grp]
        eids = self.he_e[grp]
        last = int(grp[-1])
        u_last = int(self.he_u[last])
        v_last = int(
            self.n1[u_last] if last % 2 == 0 else self.n2[u_last]
        )
        return np.append(nodes, v_last), eids


def make_rank_walker(n1, n2, e1, e2) -> RankWalker:
    """One device list-ranking pass -> a host-side chain walker."""
    term, remain = chain_ranks_device(n1, n2)
    return RankWalker(term, remain, n1, n2, e1, e2)
