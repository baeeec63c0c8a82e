"""The collective surface of the port (``distributed.collective``,
``distributed.topology``, ``env``) against the JAX package's.

The port's ranks are four gloo processes, spawned once for the module
(``test_torch_fleet_ranks.collective_rank``); the reference runs its
eager collectives in this process over a group of four devices of the
conftest's 8-device CPU mesh, where "rank r's tensor" is row r of a
``[4, ...]`` array. Rank r's result must equal row r of the reference's:

- ``all_reduce`` and ``reduce`` (dst 1: the other rows keep their value)
  under each ``ReduceOp`` (SUM, MAX, MIN, PROD, AVG), within float32
  rounding (rtol 1e-6; the reference's PROD is ``exp(psum(log))``:
  rtol 1e-5);
- ``all_reduce`` over ``new_group([1, 2])``;
- ``all_gather``, ``reduce_scatter``, ``broadcast`` (src 2), ``scatter``
  (src 0) and ``alltoall`` (one tensor; a list), exactly;
- ``send`` / ``recv``, and ``isend`` / ``irecv`` posted in both orders,
  around the ring: rank r holds rank r - 1's tensor, the reference's
  ``send_next`` (``ppermute``) under ``shard_map``; ``barrier``, ``wait``
  and ``destroy_process_group`` of a group return;
- the ranks join through ``init_parallel_env()`` with no argument (the
  launcher's ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM`` and
  ``PADDLE_MASTER``), and ``ParallelEnv`` reads their place; one process
  with no launcher makes no process group;
- ``CommunicateTopology``'s coordinates, ranks, axis lists and comm lists
  equal the reference's, with no spawn.
"""
import socket

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu.distributed as jd
import paddle_tpu.distributed.collective as JC
from paddle_tpu.distributed import ops as JO
from paddle_tpu_torch.distributed import topology as ttopo
from test_torch_fleet_ranks import WORLD, collective_rank, spawn_ranks

F32 = dict(rtol=1e-6, atol=0)


def _free_port() -> int:
    """A free port for the TCP rendezvous, below the kernel's ephemeral
    range (``ip_local_port_range``), so that no socket another process
    opens meanwhile takes it."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 30000))
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs the conftest 8-device CPU mesh")
    rng = np.random.default_rng(21)
    d = {"x": rng.uniform(0.5, 2.0, (WORLD, 3, 5)).astype(np.float32),
         "rs": rng.standard_normal((WORLD, WORLD, 3, 5)).astype(np.float32),
         "scatter": rng.standard_normal((WORLD, 3, 5)).astype(np.float32),
         "a2a": rng.standard_normal((WORLD, WORLD, 2, 3)).astype(np.float32)}
    tmp = tmp_path_factory.mktemp("collective")
    path = str(tmp / "in.npz")
    np.savez(path, **d)
    ranks = spawn_ranks(collective_rank, str(tmp), path, _free_port())
    return d, ranks


@pytest.fixture(scope="module")
def group():
    return JC.new_group(ranks=list(range(WORLD)))


def _rows(t):
    return np.asarray(t._value)


@pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "PROD", "AVG"])
def test_all_reduce_and_reduce_each_op(inputs, group, op):
    d, ranks = inputs
    tol = dict(rtol=1e-5, atol=0) if op == "PROD" else F32
    code = getattr(JC.ReduceOp, op)
    want = _rows(JC.all_reduce(JC.scatter_ranks(d["x"], group), op=code,
                               group=group))
    want_reduce = _rows(JC.reduce(JC.scatter_ranks(d["x"], group), dst=1,
                                  op=code, group=group))
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r][f"all_reduce_{op}"], want[r],
                                   **tol)
        np.testing.assert_allclose(ranks[r][f"reduce_{op}"], want_reduce[r],
                                   **tol)


def test_all_reduce_over_a_new_group(inputs):
    d, ranks = inputs
    sub = JC.new_group(ranks=[1, 2])
    want = _rows(JC.all_reduce(JC.scatter_ranks(d["x"][1:3], sub),
                               group=sub))
    for i, r in enumerate((1, 2)):
        np.testing.assert_allclose(ranks[r]["sub_all_reduce"], want[i], **F32)
        assert ranks[r]["sub_rank"] == i
    assert "sub_all_reduce" not in ranks[0]


def test_gather_scatter_broadcast_alltoall(inputs, group):
    d, ranks = inputs
    gathered = JC.all_gather([], JC.scatter_ranks(d["x"], group),
                             group=group)
    want_ag = np.stack([np.asarray(t.numpy()) for t in gathered])
    out = JC.scatter_ranks(np.zeros((WORLD, 3, 5), np.float32), group)
    want_rs = _rows(JC.reduce_scatter(out, JC.scatter_ranks(d["rs"], group),
                                      group=group))
    want_bc = _rows(JC.broadcast(JC.scatter_ranks(d["x"], group), src=2,
                                 group=group))
    want_sc = _rows(JC.scatter(JC.scatter_ranks(d["x"], group),
                               [v for v in d["scatter"]], src=0,
                               group=group))
    # the reference's rows r * 4 .. r * 4 + 3 are rank r's: row j from j
    want_a2a = _rows(JC.alltoall(JC.scatter_ranks(d["a2a"], group),
                                 group=group)).reshape(d["a2a"].shape)
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["all_gather"], want_ag)
        np.testing.assert_allclose(ranks[r]["reduce_scatter"], want_rs[r],
                                   **F32)
        np.testing.assert_array_equal(ranks[r]["broadcast"], want_bc[r])
        np.testing.assert_array_equal(ranks[r]["scatter"], want_sc[r])
        np.testing.assert_array_equal(ranks[r]["alltoall"], want_a2a[r])
        np.testing.assert_array_equal(ranks[r]["alltoall_list"], want_a2a[r])
        assert ranks[r]["world"] == (WORLD, r)
        assert ranks[r]["env"] == (r, WORLD, WORLD, r)


def test_point_to_point_around_the_ring(inputs):
    d, ranks = inputs
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("pp",))
    ring = jax.jit(jax.shard_map(lambda v: JO.send_next(v[0], "pp")[None],
                                 mesh=mesh, in_specs=P("pp"),
                                 out_specs=P("pp")))
    want = np.asarray(ring(d["x"]))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["irecv_then_isend"], want[r])
        np.testing.assert_array_equal(ranks[r]["isend_then_irecv"],
                                      2 * want[r])
        np.testing.assert_array_equal(ranks[r]["send_recv"], want[r])


@pytest.mark.parametrize("dims", [(2, 1, 1, 2), (1, 2, 2, 1), (2, 2, 1, 2)])
def test_topology_coordinates_and_comm_lists(dims):
    names = ("data", "pipe", "sharding", "model")
    ref = jd.CommunicateTopology(names, dims)
    port = ttopo.CommunicateTopology(names, dims)
    assert port.coordinate == ref.coordinate
    assert port.world_size() == ref.world_size()
    for rank in range(ref.world_size()):
        assert port.get_coord(rank) == ref.get_coord(rank)
        assert port.get_rank(**ref.get_coord(rank)) == rank
    for name in names:
        assert port.get_comm_list(name) == ref.get_comm_list(name)
        assert port.get_dim(name) == ref.get_dim(name)
        for i in range(ref.get_dim(name)):
            assert port.get_axis_list(name, i) == ref.get_axis_list(name, i)


def test_init_parallel_env_without_a_launcher(monkeypatch):
    from paddle_tpu_torch.distributed import env

    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
        monkeypatch.delenv(k, raising=False)
    penv = env.init_parallel_env()
    assert (penv.rank, penv.world_size, env.is_initialized()) == (0, 1, False)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(ValueError, match="PADDLE_MASTER"):
        env.init_parallel_env()
