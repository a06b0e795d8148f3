"""The port's ``core`` package exports what ``repro.core`` exports for one
column's statistics, and those functions agree with the JAX package's.

``column_stats`` and ``accumulate_column`` are held against
``repro.core``'s on the same numpy inputs with the tolerances of
``tests/test_torch_estimators.py`` (counts and extrema exact, float sums to
rtol 1e-5); ``psum_stats`` over a one-process group is the identity.
"""

import socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jcore
import repro_torch.core as tcore

NAMES = ("accumulate_column", "column_stats", "psum_stats")


def _window(n, s, seed):
    rng = np.random.default_rng(seed)
    sidx = np.minimum((rng.random(n) ** 2 * s).astype(np.int32), s - 1)
    values = rng.normal(20.0, 6.0, n).astype(np.float32)
    mask = rng.random(n) < 0.6
    return sidx, values, mask


@pytest.mark.parametrize("name", NAMES)
def test_core_exports_the_column_functions(name):
    assert name in tcore.__all__
    assert getattr(tcore, name) is getattr(tcore.estimators, name)
    assert name in jcore.__all__


@pytest.mark.parametrize("n,s,extrema", [(500, 9, True), (6000, 60, True), (6000, 60, False)])
def test_column_stats_matches_jax(n, s, extrema):
    sidx, values, mask = _window(n, s, seed=n + s)
    got = tcore.column_stats(torch.from_numpy(values), torch.from_numpy(sidx),
                             torch.from_numpy(mask), s, extrema=extrema)
    want = jcore.column_stats(jnp.asarray(values), jnp.asarray(sidx), jnp.asarray(mask), s,
                              extrema=extrema)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("n", "min", "max"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3, err_msg=name)


def test_accumulate_column_matches_jax():
    sidx, values, mask = _window(4000, 30, seed=3)
    kinds = ("moments", "extrema", "sketch")
    got = tcore.accumulate_column(kinds, *(torch.from_numpy(a) for a in (values, sidx, mask)), 30)
    want = jcore.accumulate_column(kinds, jnp.asarray(values), jnp.asarray(sidx),
                                   jnp.asarray(mask), 30)
    assert set(got) == set(want) == set(kinds)
    for kind in kinds:
        for g, w in zip(got[kind], want[kind]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3,
                                       err_msg=kind)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_psum_stats_of_one_process_is_identity(monkeypatch):
    import torch.distributed as dist

    sidx, values, mask = _window(2000, 20, seed=4)
    stats = tcore.column_stats(torch.from_numpy(values), torch.from_numpy(sidx),
                               torch.from_numpy(mask), 20).base
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        out = tcore.psum_stats(stats)
    finally:
        dist.destroy_process_group()
    for name, g, w in zip(stats._fields, out, stats):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4, msg=name)
