"""Downstream routing: river-network accumulation of link runoff.

The reference carries the routing topology (``next_stream`` in SpatialParams,
``Stream::next_id`` — src/stream.hpp:31, parameters_loader.hpp:21) but never
uses it: "routing is future work" (SURVEY.md 2.1).  BASELINE.json's north star
asks for exactly this: a downstream-routing exchange across shards.  This
module implements it:

  - ``build_topology``: stream/next_stream ids -> dense downstream index array
    (outlets and links draining outside the basin get -1) + network depth;
  - ``link_runoff_204``: instantaneous outflow volume rate per link from the
    Model-204 stores (surface Manning outflow + interflow + baseflow), the
    quantity being routed;
  - ``accumulate_downstream``: single-device accumulation
    acc = (I - S)^-1 q for the (nilpotent) downstream scatter matrix S,
    computed by fixpoint iteration acc <- q + S acc, which is exact after
    ``depth`` rounds — each round is one vectorized scatter-add (no serial
    graph walk);
  - ``accumulate_downstream_sharded``: the multi-device version under
    ``shard_map``: local edges scatter in-shard; cross-shard contributions are
    packed into fixed-size per-shard outboxes and delivered with a ring of
    ``jax.lax.ppermute`` steps each round, so the exchange rides the
    device interconnect and can overlap with step compute.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


class Topology(NamedTuple):
    next_idx: np.ndarray  # [S] int32; downstream link's row, -1 if none in basin
    depth: int  # longest path length (rounds needed for exact accumulation)
    # [R, S] int32 pointer-doubling tables: row j holds each link's 2^j-th
    # downstream row (-1 if the path ends sooner).  R = ceil(log2(depth+1)),
    # so  acc = (I+S)(I+S^2)(I+S^4)...q  reaches every ancestor in O(log
    # depth) scatter rounds instead of O(depth) fixpoint rounds.
    ptr_tables: np.ndarray


def build_topology(stream_ids: np.ndarray, next_stream_ids: np.ndarray) -> Topology:
    """Resolve next_stream ids to row indices; compute network depth (host)."""
    stream_ids = np.asarray(stream_ids, np.int64)
    next_ids = np.asarray(next_stream_ids, np.int64)
    order = np.argsort(stream_ids, kind="stable")
    sorted_ids = stream_ids[order]
    pos = np.searchsorted(sorted_ids, next_ids)
    pos_clip = np.clip(pos, 0, len(sorted_ids) - 1)
    found = sorted_ids[pos_clip] == next_ids
    next_idx = np.where(found, order[pos_clip], -1).astype(np.int32)

    # Path length to termination via pointer doubling (host, O(S log depth)):
    # cnt[i] = hops accumulated along ptr; after round k, ptr is the 2^k-th
    # successor (or -1 once the path end is absorbed).  The ptr snapshots ARE
    # the device doubling tables — collected for free.
    if len(next_idx) == 0:
        return Topology(
            next_idx=next_idx, depth=0,
            ptr_tables=np.zeros((0, 0), np.int32),
        )
    ptr = next_idx.astype(np.int64)
    cnt = (ptr >= 0).astype(np.int64)
    tables = []
    rounds = 0
    while (ptr >= 0).any():
        tables.append(ptr.astype(np.int32))
        idx = np.clip(ptr, 0, None)
        cnt = cnt + np.where(ptr >= 0, cnt[idx], 0)
        ptr = np.where(ptr >= 0, ptr[idx], -1)
        rounds += 1
        if rounds > int(np.log2(len(next_idx) + 1)) + 2:
            raise ValueError("Routing topology contains a cycle")
    depth = int(cnt.max())
    n_rounds = 0 if depth == 0 else int(np.ceil(np.log2(depth + 1)))
    ptr_tables = (
        np.stack(tables[:n_rounds])
        if n_rounds
        else np.zeros((0, len(next_idx)), np.int32)
    )
    return Topology(next_idx=next_idx, depth=depth, ptr_tables=ptr_tables)


def link_runoff_204(y: jax.Array, params) -> jax.Array:
    """Instantaneous local outflow per link [m * km^2 / min] from Model-204
    stores — delegates to models.model204.link_outflow (the SAME hydraulics
    the solver integrates, model_204.hpp:99-113)."""
    from tiger_tpu.models.model204 import link_outflow

    return link_outflow(y, params)


@functools.partial(jax.jit, static_argnames=("n_iters",))
def accumulate_downstream(q: jax.Array, next_idx: jax.Array, n_iters: int) -> jax.Array:
    """acc[v] = q[v] + sum of q over all links upstream of v (single device).

    O(depth) fixpoint reference implementation (acc <- q + S acc, exact after
    ``n_iters`` >= Topology.depth rounds).  Production paths use the
    O(log depth) ``accumulate_downstream_log``; this stays as the brute-force
    oracle for equivalence tests.
    """
    valid = next_idx >= 0
    tgt = jnp.where(valid, next_idx, 0)

    def body(_, acc):
        contrib = jnp.where(valid, acc, 0.0)
        gathered = jnp.zeros_like(q).at[tgt].add(contrib, mode="drop")
        return q + gathered

    return jax.lax.fori_loop(0, n_iters, body, q)


@jax.jit
def accumulate_downstream_log(q: jax.Array, ptr_tables: jax.Array) -> jax.Array:
    """acc[v] = q[v] + sum over upstream links, in O(log depth) rounds.

    Uses the factorization (I + S)(I + S^2)(I + S^4)...q = sum_k S^k q: round
    j scatter-adds the CURRENT partial sums through the 2^j-th-successor
    table, so each of the log2(depth) rounds is one vectorized scatter — the
    device analog of build_topology's host pointer doubling.
    """

    def body(x, ptr_row):
        valid = ptr_row >= 0
        tgt = jnp.where(valid, ptr_row, 0)
        return x.at[tgt].add(jnp.where(valid, x, 0.0), mode="drop"), None

    out, _ = jax.lax.scan(body, q, ptr_tables)
    return out


@jax.jit
def _routed_discharge_jit(dense, params, tables):
    def per_time(y_slice):  # [S, N]
        q = link_runoff_204(jnp.nan_to_num(y_slice), params)
        return accumulate_downstream_log(q, tables)

    return jax.vmap(per_time, in_axes=1, out_axes=1)(dense)


#: One-slot device cache for Topology.ptr_tables: chunked runs call
#: routed_discharge once per window with the SAME topology — re-uploading the
#: [rounds, S] tables (5-9 MB at 131k links) every window would move more
#: bytes than the routing itself.  The cache holds the HOST
#: array itself and compares with ``is``: an id()-keyed cache can serve a
#: stale topology when CPython recycles the address of a collected ndarray.
_tables_cache: tuple = (None, None)


def _device_tables(topo: Topology) -> jax.Array:
    global _tables_cache
    if _tables_cache[0] is not topo.ptr_tables:
        _tables_cache = (topo.ptr_tables, jnp.asarray(topo.ptr_tables))
    return _tables_cache[1]


def routed_discharge(
    dense: jax.Array,  # [S, Q, N] dense state output
    params,  # SoA dict with the Model-204 hydraulic fields
    topo: Topology,
) -> jax.Array:
    """Routed hydrograph [S, Q]: downstream-accumulated link outflow at each
    query time (NaN states — unfinished lanes — contribute zero).

    Combines link_runoff_204 (local outflow from the stores) with the
    network accumulation — the discharge time series at every link that the
    reference's never-implemented routing was meant to produce.  One jitted
    computation instead of ~10 eager dispatches per call.
    """
    return _routed_discharge_jit(dense, params, _device_tables(topo))


class ShardedTopology(NamedTuple):
    """Per-shard static routing plan (host-precomputed, stacked over shards).

    One plan slice per pointer-doubling round (leading R axis): round j's
    edges are u -> 2^j-th-successor(u).  Local edges scatter within the
    shard; remote edges are packed into a fixed-width outbox (padded with -1
    targets) and ring-delivered.  Total collective cost is
    O(log depth * n_shards) ppermute hops vs the O(depth * n_shards) of a
    fixpoint iteration.
    """

    local_tgt: np.ndarray  # [R, D, B] int32: in-shard target row or -1
    outbox_src: np.ndarray  # [R, D, M] int32: local row feeding outbox slot, -1 pad
    outbox_shard: np.ndarray  # [R, D, M] int32: destination shard, -1 pad
    outbox_row: np.ndarray  # [R, D, M] int32: destination row within shard, -1 pad
    n_shards: int
    block: int
    depth: int
    n_rounds: int
    # Shard row ranges in GLOBAL row coordinates (starts[d] .. starts[d] +
    # sizes[d]); uniform ``block`` partition unless ``bounds`` was given.
    starts: tuple = ()
    sizes: tuple = ()
    # Per-round outbox width (max over shards): round j only circulates its
    # own m_j slots instead of the global max M — later doubling rounds have
    # far fewer surviving edges, so uniform-M ring traffic overstates by the
    # ratio sum(m_j)/R*M.
    round_slots: tuple = ()


def plan_sharded_topology(
    topo: Topology, n_shards: int, bounds=None
) -> ShardedTopology:
    """Split a Topology over ``n_shards`` contiguous row blocks (host).

    ``bounds``: optional explicit per-shard row ranges (sequence of slices,
    e.g. ``params.split_even`` — the production multi-process partition,
    which spreads the remainder over the FIRST shards rather than
    short-changing only the last).  Default: uniform ceil(S/D) blocks.
    Each shard's rows are addressed locally as ``global_row - starts[d]``;
    callers lay q out as [D, block] with each shard's tail padded.
    """
    s_total = len(topo.next_idx)
    n_rounds = topo.ptr_tables.shape[0]
    rows = np.arange(s_total)
    if bounds is None:
        block = -(-s_total // max(n_shards, 1))  # ceil
        starts = np.arange(n_shards) * block
        sizes = np.clip(s_total - starts, 0, block)
        src_shard = rows // max(block, 1)
    else:
        if len(bounds) != n_shards:
            raise ValueError(f"bounds has {len(bounds)} slices, want {n_shards}")
        starts = np.array([b.start for b in bounds])
        sizes = np.array([b.stop - b.start for b in bounds])
        if starts[0] != 0 or (starts[1:] != (starts + sizes)[:-1]).any() or (
            starts + sizes
        )[-1] != s_total:
            raise ValueError("bounds must be contiguous and cover all rows")
        block = int(sizes.max()) if n_shards else 0
        src_shard = np.searchsorted(starts, rows, side="right") - 1

    def to_shard(grows):
        d = np.searchsorted(starts, grows, side="right") - 1 if bounds is not None \
            else grows // max(block, 1)
        return d, grows - starts[d]

    local_tgt = np.full((max(n_rounds, 1), n_shards, max(block, 1)), -1, np.int32)
    out_src, out_shard, out_row = [], [], []
    for j in range(n_rounds):
        edges = topo.ptr_tables[j]
        safe = np.clip(edges, 0, None)
        e_shard, e_row = to_shard(safe)
        tgt_shard = np.where(edges >= 0, e_shard, -1)
        tgt_row = np.where(edges >= 0, e_row, -1)
        src_row = rows - starts[src_shard]
        for d in range(n_shards):
            mine = src_shard == d
            local = mine & (tgt_shard == d)
            local_tgt[j, d, src_row[local]] = tgt_row[local]
            remote = mine & (tgt_shard >= 0) & (tgt_shard != d)
            out_src.append(src_row[remote])
            out_shard.append(tgt_shard[remote])
            out_row.append(tgt_row[remote])
    m = max(1, max((len(x) for x in out_src), default=1))
    pad = lambda xs: np.stack(
        [np.pad(x, (0, m - len(x)), constant_values=-1).astype(np.int32) for x in xs]
    ).reshape(n_rounds, n_shards, m)

    if n_rounds == 0:
        empty = np.full((1, n_shards, 1), -1, np.int32)
        out_arrs = (empty, empty, empty)
        round_slots = ()
    else:
        out_arrs = (pad(out_src), pad(out_shard), pad(out_row))
        round_slots = tuple(
            max(1, max(len(out_src[j * n_shards + d]) for d in range(n_shards)))
            for j in range(n_rounds)
        )
    return ShardedTopology(
        local_tgt=local_tgt,
        outbox_src=out_arrs[0],
        outbox_shard=out_arrs[1],
        outbox_row=out_arrs[2],
        n_shards=n_shards,
        block=block,
        depth=topo.depth,
        n_rounds=n_rounds,
        starts=tuple(int(x) for x in starts),
        sizes=tuple(int(x) for x in sizes),
        round_slots=round_slots,
    )


#: One-slot device cache for ShardedTopology plan tables (same rationale and
#: identity semantics as _tables_cache: per-window calls reuse ONE plan).
_plan_cache: tuple = (None, None)


def _device_plan(plan: ShardedTopology):
    global _plan_cache
    if _plan_cache[0] is not plan.local_tgt:
        _plan_cache = (
            plan.local_tgt,
            tuple(
                jnp.asarray(a)
                for a in (
                    plan.local_tgt, plan.outbox_src,
                    plan.outbox_shard, plan.outbox_row,
                )
            ),
        )
    return _plan_cache[1]


def exchange_sharded(q_g: jax.Array, plan: ShardedTopology, mesh: Mesh) -> jax.Array:
    """Multi-chip downstream accumulation of ``q_g [D, B, W]`` — shard_map +
    ring ppermute delivery, with a trailing payload axis W (e.g. a window's
    query times, so one exchange routes a whole dense window).

    ``q_g`` may be any global array sharded (or shardable) as P(axis) on its
    leading shard axis — including cross-process arrays built with
    ``jax.make_array_from_process_local_data`` — with each shard's rows
    beyond ``plan.sizes[d]`` zero-padded.  Each pointer-doubling round does
    the in-shard scatter of the current partial sums, then circulates the
    remote outboxes one full ring so every cross-shard contribution lands
    this round (the exchange is exactly the reference's missing MPI neighbor
    transfer, stream.hpp:31 / SURVEY.md 2.10, built from XLA collectives
    instead).  O(log depth) rounds total (see ShardedTopology); bytes on the
    wire per call = n_rounds * (D-1) hops * M slots * (W * 4 + 4) — vs the
    allgather oracle's S_total * W * 4 delivered to EVERY shard.
    """
    axis = mesh.axis_names[0]
    n = plan.n_shards
    perm = [(i, (i + 1) % n) for i in range(n)]

    procs = {d.process_index for d in mesh.devices.flat}
    if len(procs) > 1:
        # Cross-process mesh: hand shard_map the HOST plan tables (identical
        # on every process — deterministic from the topology), which jit
        # shards consistently; a per-process jnp.asarray would be committed
        # to one local device and clash with the global mesh.
        lt, ob_src, ob_shard, ob_row = (
            plan.local_tgt, plan.outbox_src, plan.outbox_shard, plan.outbox_row
        )
    else:
        lt, ob_src, ob_shard, ob_row = _device_plan(plan)

    def shard_body(q_blk, lt_blk, src_blk, shard_blk, row_blk):
        acc = q_blk[0]  # [B, W]
        me = jax.lax.axis_index(axis)

        # Rounds are Python-unrolled (R <= ceil(log2(depth)) ~ 10): each
        # round circulates only its OWN outbox width plan.round_slots[j] —
        # a uniform scan would make every round pay the WORST round's
        # traffic (later doubling rounds have far fewer surviving edges).
        for j in range(plan.n_rounds):
            m_j = plan.round_slots[j]
            lt_r = lt_blk[j, 0]
            src = src_blk[j, 0, :m_j]
            dst_shard = shard_blk[j, 0, :m_j]
            dst_row = row_blk[j, 0, :m_j]
            # In-shard scatter of the CURRENT partial sums (doubling update
            # x <- x + S_j x, not the fixpoint's q + S x).
            valid_l = lt_r >= 0
            add_local = jnp.zeros_like(acc).at[jnp.where(valid_l, lt_r, 0)].add(
                jnp.where(valid_l[:, None], acc, 0.0), mode="drop"
            )
            new_acc = acc + add_local
            # Pack outbox: contribution of src rows (pre-round acc values).
            # Destination (shard, row) travels with the slot as one packed
            # integer payload so two ppermutes move value + address together.
            valid_o = src >= 0
            vals = jnp.where(
                valid_o[:, None], acc[jnp.where(valid_o, src, 0)], 0.0
            )
            packed = jnp.where(valid_o, dst_shard * plan.block + dst_row, -1)

            # Ring-circulate (n-1 hops): deliver slots addressed to me.
            def hop(carry, _):
                new_acc, vals, packed = carry
                vals = jax.lax.ppermute(vals, axis, perm)
                packed = jax.lax.ppermute(packed, axis, perm)
                deliver = (packed >= 0) & ((packed // plan.block) == me)
                rowt = jnp.where(deliver, packed % plan.block, 0)
                new_acc = new_acc.at[rowt].add(
                    jnp.where(deliver[:, None], vals, 0.0), mode="drop"
                )
                vals = jnp.where(deliver[:, None], 0.0, vals)
                packed = jnp.where(deliver, -1, packed)
                return (new_acc, vals, packed), None

            (acc, _, _), _ = jax.lax.scan(
                hop, (new_acc, vals, packed), None, length=n - 1
            )
        return acc[None]

    fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(
            P(axis), P(None, axis), P(None, axis), P(None, axis), P(None, axis)
        ),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(q_g, lt, ob_src, ob_shard, ob_row)


def accumulate_downstream_sharded(
    q: jax.Array, plan: ShardedTopology, mesh: Mesh
) -> jax.Array:
    """Single-vector wrapper of :func:`exchange_sharded`: ``q`` is the global
    [S_padded] runoff vector (S_padded = n_shards*block, uniform blocks)."""
    q2 = q.reshape(plan.n_shards, plan.block, 1)
    return exchange_sharded(q2, plan, mesh).reshape(-1)


def ring_bytes_per_exchange(plan: ShardedTopology, w: int, itemsize: int = 4) -> int:
    """Bytes a ring exchange moves over the interconnect (all hops, all
    rounds): round j circulates its m_j-slot outbox (values [m_j, W] +
    packed addresses [m_j] int32) through D-1 hops."""
    return sum(
        (plan.n_shards - 1) * m_j * (w * itemsize + 4)
        for m_j in plan.round_slots
    )


def allgather_bytes_per_exchange(
    s_total: int, w: int, n_eq: int, n_shards: int, itemsize: int = 4
) -> int:
    """Bytes the allgather oracle DELIVERS per window: every shard receives
    the full [S_total, W, n_eq] dense block (run.py's process_allgather)."""
    return n_shards * s_total * w * n_eq * itemsize
