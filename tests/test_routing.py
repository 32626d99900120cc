"""Routing: topology build, single-device and sharded downstream accumulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tiger_tpu import routing


def _random_forest(rng, n):
    """Random forest where next-in-row-order goes strictly downstream; ids are
    random (unsorted), so id->row resolution is exercised."""
    next_row = np.full(n, -1, np.int64)
    for i in range(n - 1):
        if rng.uniform() < 0.85:
            next_row[i] = rng.integers(i + 1, n)
    ids = rng.choice(1_000_000, size=n, replace=False) + 1  # unique nonzero ids
    nxt = np.where(next_row >= 0, ids[np.clip(next_row, 0, None)], -999)
    return ids, nxt


def _brute_accumulate(q, next_idx):
    n = len(q)
    acc = q.astype(np.float64).copy()
    # push each link's q down its entire path
    for i in range(n):
        j = next_idx[i]
        while j >= 0:
            acc[j] += q[i]
            j = next_idx[j]
    return acc


def test_topology_and_accumulate_small():
    # chain 0->1->2->3, plus 4->2, 5 outlet
    stream = np.array([10, 20, 30, 40, 50, 60])
    nxt = np.array([20, 30, 40, -1, 30, -1])
    topo = routing.build_topology(stream, nxt)
    np.testing.assert_array_equal(topo.next_idx, [1, 2, 3, -1, 2, -1])
    assert topo.depth == 3
    q = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
    acc = np.asarray(routing.accumulate_downstream(jnp.asarray(q), jnp.asarray(topo.next_idx), topo.depth))
    np.testing.assert_allclose(acc, _brute_accumulate(q, topo.next_idx))


def test_accumulate_random_network():
    rng = np.random.default_rng(11)
    stream, nxt = _random_forest(rng, 200)
    topo = routing.build_topology(stream, nxt)
    q = rng.uniform(0, 1, 200)
    acc = np.asarray(
        routing.accumulate_downstream(jnp.asarray(q), jnp.asarray(topo.next_idx), topo.depth)
    )
    np.testing.assert_allclose(acc, _brute_accumulate(q, topo.next_idx), rtol=1e-12)


def test_cycle_detection():
    with pytest.raises(ValueError, match="cycle"):
        routing.build_topology(np.array([1, 2]), np.array([2, 1]))


def test_sharded_accumulate_matches_single_device():
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual device mesh")
    from tiger_tpu.dist import systems_mesh

    rng = np.random.default_rng(5)
    n_dev = 8
    stream, nxt = _random_forest(rng, 16 * n_dev - 3)
    topo = routing.build_topology(stream, nxt)
    plan = routing.plan_sharded_topology(topo, n_dev)
    s_pad = plan.n_shards * plan.block

    q = rng.uniform(0, 1, len(stream))
    q_pad = np.zeros(s_pad)
    q_pad[: len(q)] = q

    mesh = systems_mesh(jax.devices()[:n_dev])
    acc_sharded = np.asarray(
        routing.accumulate_downstream_sharded(jnp.asarray(q_pad), plan, mesh)
    )[: len(q)]
    acc_ref = np.asarray(
        routing.accumulate_downstream(jnp.asarray(q), jnp.asarray(topo.next_idx), topo.depth)
    )
    np.testing.assert_allclose(acc_sharded, acc_ref, rtol=1e-12)


def test_link_runoff_204_shapes():
    params = {
        "n_mann": jnp.full(3, 0.03),
        "slope": jnp.full(3, 0.05),
        "L": jnp.full(3, 1.0),
        "A_h": jnp.full(3, 10.0),
        "alpha3": jnp.full(3, 2880.0),
        "alpha4": jnp.full(3, 7200.0),
    }
    y = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (3, 5)))
    q = routing.link_runoff_204(y, params)
    assert q.shape == (3,)
    assert bool((np.asarray(q) >= 0).all())


def test_log_accumulate_matches_brute_random_forest():
    rng = np.random.default_rng(17)
    ids, nxt = _random_forest(rng, 300)
    topo = routing.build_topology(ids, nxt)
    q = rng.uniform(0, 1, 300)
    acc_log = np.asarray(
        routing.accumulate_downstream_log(jnp.asarray(q), jnp.asarray(topo.ptr_tables))
    )
    np.testing.assert_allclose(acc_log, _brute_accumulate(q, topo.next_idx), rtol=1e-12)
    # And equals the O(depth) fixpoint oracle.
    acc_fix = np.asarray(
        routing.accumulate_downstream(jnp.asarray(q), jnp.asarray(topo.next_idx), topo.depth)
    )
    np.testing.assert_allclose(acc_log, acc_fix, rtol=1e-12)


def test_log_accumulate_deep_chain():
    # Deep path (depth 999): log-depth needs only ceil(log2(1000)) = 10 rounds.
    n = 1000
    ids = np.arange(1, n + 1)
    nxt = np.concatenate([ids[1:], [-1]])
    topo = routing.build_topology(ids, nxt)
    assert topo.depth == n - 1
    assert topo.ptr_tables.shape[0] == int(np.ceil(np.log2(n)))
    q = np.ones(n)
    acc = np.asarray(
        routing.accumulate_downstream_log(jnp.asarray(q), jnp.asarray(topo.ptr_tables))
    )
    np.testing.assert_allclose(acc, np.arange(1, n + 1, dtype=np.float64))


def test_sharded_log_accumulate_deep_chain_crossing_shards():
    if len(jax.devices()) < 8:
        pytest.skip("needs virtual device mesh")
    from tiger_tpu.dist import systems_mesh

    n_dev = 8
    n = 16 * n_dev  # chain crossing every shard boundary
    ids = np.arange(1, n + 1)
    nxt = np.concatenate([ids[1:], [-1]])
    topo = routing.build_topology(ids, nxt)
    plan = routing.plan_sharded_topology(topo, n_dev)
    assert plan.n_rounds == topo.ptr_tables.shape[0]
    mesh = systems_mesh(jax.devices()[:n_dev])
    q = np.random.default_rng(3).uniform(0, 1, n)
    acc = np.asarray(
        routing.accumulate_downstream_sharded(jnp.asarray(q), plan, mesh)
    )
    np.testing.assert_allclose(acc, _brute_accumulate(q, topo.next_idx), rtol=1e-12)


def test_link_runoff_clamps_negative_stores():
    """Dense-interpolant overshoot (slightly negative h_surface) must give
    zero outflow, not NaN (pow(negative, 2/3)) silently poisoning every
    downstream discharge value."""
    import jax.numpy as jnp

    from tiger_tpu.routing import link_runoff_204

    params = {
        "n_mann": jnp.asarray([0.1, 0.1]), "slope": jnp.asarray([0.02, 0.02]),
        "L": jnp.asarray([0.6, 0.6]), "A_h": jnp.asarray([0.76, 0.76]),
        "alpha3": jnp.asarray([2880.0, 2880.0]),
        "alpha4": jnp.asarray([79200.0, 79200.0]),
    }
    y = jnp.asarray([
        [0.0, 0.0, -1e-7, -1e-9, 0.2],   # overshoot lane
        [0.0, 0.0, 0.5, 1.0, 0.2],
    ])
    q = np.asarray(link_runoff_204(y, params))
    assert np.isfinite(q).all()
    assert q[0] >= 0.0 and q[1] > 0.0


def test_sharded_accumulate_split_even_bounds_with_payload():
    """Production layout: plan over params.split_even bounds (remainder on
    the FIRST shards) with a trailing payload axis — exchange_sharded must
    match the brute-force accumulation column by column."""
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual device mesh")
    from tiger_tpu.dist import systems_mesh
    from tiger_tpu.params import split_even

    rng = np.random.default_rng(11)
    n_dev, w = 4, 5
    n = 16 * n_dev + 3  # uneven: first 3 shards get an extra row
    stream, nxt = _random_forest(rng, n)
    topo = routing.build_topology(stream, nxt)
    bounds = split_even(n, n_dev)
    plan = routing.plan_sharded_topology(topo, n_dev, bounds=bounds)
    assert plan.block == max(b.stop - b.start for b in bounds)

    q = rng.uniform(0, 1, (n, w))
    q_g = np.zeros((n_dev, plan.block, w))
    for d, b in enumerate(bounds):
        q_g[d, : b.stop - b.start] = q[b]
    mesh = systems_mesh(jax.devices()[:n_dev])
    out = np.asarray(
        routing.exchange_sharded(jnp.asarray(q_g), plan, mesh)
    )
    acc = np.concatenate(
        [out[d, : b.stop - b.start] for d, b in enumerate(bounds)], axis=0
    )
    for col in range(w):
        np.testing.assert_allclose(
            acc[:, col], _brute_accumulate(q[:, col], topo.next_idx), rtol=1e-12
        )
    # Byte accounting sanity: the ring moves less than the allgather oracle
    # delivers for this (tiny) case scaled to any n_eq >= 1.
    ring = routing.ring_bytes_per_exchange(plan, w)
    gather = routing.allgather_bytes_per_exchange(n, w, 1, n_dev)
    assert ring > 0 and gather > 0


def test_ring_routed_window_matches_routed_discharge():
    """A dense window routed through the ppermute ring over a 4-device mesh
    (chip_smoke.ring_routed, solve_chunked's routed_fn in the four-card
    phase) equals the single-device routed discharge of the whole basin."""
    if len(jax.devices()) < 4:
        pytest.skip("needs virtual device mesh")
    from chip_smoke import ring_routed
    from tiger_tpu.dist import systems_mesh

    n_dev, s_count = 4, 4 * 64
    stream = np.arange(1, s_count + 1)
    nxt = np.where(stream % 37 == 0, -1, stream + 1)  # chains cross every shard
    nxt[-1] = -1
    topo = routing.build_topology(stream, nxt)
    rng = np.random.default_rng(2)
    params = {
        k: jnp.asarray(rng.uniform(0.8, 1.2, s_count) * v, jnp.float32)
        for k, v in dict(n_mann=0.03, slope=0.05, L=1.0, A_h=10.0,
                         alpha3=2880.0, alpha4=7200.0).items()
    }
    dense = jnp.asarray(rng.uniform(0, 1, (s_count, 3, 5)), jnp.float32)
    dense = dense.at[5, 1].set(jnp.nan)  # an unfinished lane contributes 0
    fn, plan = ring_routed(topo, params, systems_mesh(jax.devices()[:n_dev]))
    assert plan.n_shards == n_dev and plan.n_rounds == topo.ptr_tables.shape[0]
    out = np.asarray(fn(dense))
    ref = np.asarray(routing.routed_discharge(dense, params, topo))
    assert out.shape == ref.shape == (s_count, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-9)
