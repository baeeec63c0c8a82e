"""The port's parameter-server transport (``paddle_tpu_torch.distributed.
ps.service``) against the JAX package's, in-process (servers on threads,
as the reference's tests run them):

- the wire: the bytes ``_send_msg`` writes for the same messages, and
  for a whole client session with its server's replies, are the
  reference's; each package decodes the other's;
- interop both ways round: a port client against reference servers and a
  reference client against port servers give what a reference pair gives,
  with the reference's sharding (a dense table whole on
  ``crc32(name) % n``, a sparse row on ``id % n``);
- the snapshot files of ``save_tables`` load in the other package (the
  shard-count check included); a rejoining worker's init cannot clobber a
  live table; the barrier holds until every worker arrives.
"""
import pickle
import threading
import zlib

import numpy as np
import pytest

from paddle_tpu.distributed.ps import service as RS
from paddle_tpu_torch.distributed.ps import service as PS
from paddle_tpu_torch.distributed.ps import native_tables

JOIN_S = 10.0


def _cluster(S, n=2, n_workers=1):
    servers = [S.PsServer(port=0, n_workers=n_workers,
                          host="127.0.0.1").start() for _ in range(n)]
    return servers, [f"127.0.0.1:{s.port}" for s in servers]


def _close(clients, servers):
    for c in clients:
        c.close()
    for s in servers:
        s.stop()


class _Tap:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.sent = []

    def sendall(self, data):
        self.sent.append(bytes(data))


MESSAGES = [("create_dense", "fc.weight", 12, "sgd", 0.5),
            ("push_sparse", "emb", np.arange(5, dtype=np.int64),
             np.ones((5, 4), np.float32)),
            ("ok", np.linspace(0, 1, 7, dtype=np.float32)),
            ("err", "ValueError('x')"), ("barrier",), ("stop",)]


def test_send_msg_bytes_are_the_references():
    ref, port = _Tap(), _Tap()
    for msg in MESSAGES:
        RS._send_msg(ref, msg)
        PS._send_msg(port, msg)
    assert ref.sent == port.sent
    for blob, msg in zip(port.sent, MESSAGES):
        n = int.from_bytes(blob[:4], "little")
        assert n == len(blob) - 4
        back = pickle.loads(blob[4:])
        assert back[0] == msg[0] and len(back) == len(msg)


def _session(client):
    """One client session; returns what it read."""
    out = {}
    client.create_dense("fc.weight", 6, "sgd", 0.5,
                        init=np.arange(6, dtype=np.float32))
    client.push_dense("fc.weight", np.ones(6, np.float32))
    out["dense"] = client.pull_dense("fc.weight")
    client.create_sparse("emb", 4, "adagrad", 0.1, seed=3)
    ids = np.array([0, 1, 2, 3, 101, 202, 1], np.int64)
    out["rows"] = client.pull_sparse("emb", ids)
    client.push_sparse("emb", ids, np.full((ids.size, 4), 0.5, np.float32))
    out["rows2"] = client.pull_sparse("emb", ids)
    out["size"] = client.sparse_size("emb")
    e_ids, e_rows = client.export_sparse("emb")
    order = np.argsort(e_ids)
    out["export"] = (e_ids[order], e_rows[order])
    client.put_blob("k", b"abc")
    client.put_blob("k", b"de")
    out["blobs"] = client.take_blobs("k")
    client.barrier()
    return out


def test_session_bytes_are_the_references(monkeypatch):
    """One server: the client's requests and the server's replies, in
    order, byte for byte."""
    sent = {}
    for name, S in (("ref", RS), ("port", PS)):
        log = sent[name] = []
        real = S._send_msg

        def record(sock, obj, real=real, log=log):
            log.append(pickle.dumps(obj, protocol=4))
            real(sock, obj)

        monkeypatch.setattr(S, "_send_msg", record)
        servers, eps = _cluster(S, n=1)
        client = S.PsClient(eps)
        try:
            _session(client)
        finally:
            _close([client], servers)
    assert len(sent["ref"]) == len(sent["port"]) > 20
    assert sent["ref"] == sent["port"]


def _check_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple):
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [(PS, RS), (RS, PS)],
                         ids=["port_client_ref_servers",
                              "ref_client_port_servers"])
def test_interop_both_ways(client_pkg, server_pkg):
    assert native_tables()
    servers, eps = _cluster(RS)
    want_client = RS.PsClient(eps)
    try:
        want = _session(want_client)
    finally:
        _close([want_client], servers)
    servers, eps = _cluster(server_pkg)
    client = client_pkg.PsClient(eps)
    try:
        got = _session(client)
        # the reference's sharding: the dense table whole on its home,
        # every sparse row on id % n
        home = zlib.crc32(b"fc.weight") % 2
        assert [("fc.weight" in s._dense) for s in servers] == \
            [i == home for i in range(2)]
        for i, s in enumerate(servers):
            ids, _ = s._sparse["emb"].export()
            assert ids.size and (ids % 2 == i).all()
    finally:
        _close([client], servers)
    _check_same(want, got)


@pytest.mark.parametrize("save_pkg,load_pkg", [(PS, RS), (RS, PS)],
                         ids=["port_saves", "ref_saves"])
def test_snapshot_loads_in_the_other(tmp_path, save_pkg, load_pkg):
    ids = np.array([1, 5, 9, 12], np.int64)
    g = np.tile(np.array([0.5, -1.0, 0.25, 2.0], np.float32), (4, 1))
    snap = str(tmp_path / "snap")
    servers, eps = _cluster(save_pkg)
    survivor_servers, survivor_eps = _cluster(save_pkg)
    client = save_pkg.PsClient(eps)
    survivor = save_pkg.PsClient(survivor_eps)
    try:
        for c in (client, survivor):
            c.create_dense("w", 6, "adagrad", 0.1,
                           init=np.arange(6, dtype=np.float32))
            c.create_sparse("emb", 4, "adagrad", 0.05, seed=3)
            c.pull_sparse("emb", ids)
            c.push_sparse("emb", ids, g)
            c.push_dense("w", np.ones(6, np.float32))
        assert client.save_tables(snap) == 3  # w on one shard, emb on both
        client.stop_servers()
        client.close()
        for s in servers:
            s.stop()
        fresh, fresh_eps = _cluster(load_pkg)
        loaded = load_pkg.PsClient(fresh_eps)
        try:
            assert loaded.load_tables(snap) == 3
            loaded._sparse_dims["emb"] = 4
            np.testing.assert_array_equal(loaded.pull_dense("w"),
                                          survivor.pull_dense("w"))
            np.testing.assert_array_equal(loaded.pull_sparse("emb", ids),
                                          survivor.pull_sparse("emb", ids))
            for c in (loaded, survivor):  # the accumulators came back
                c.push_sparse("emb", ids, g)
                c.push_dense("w", np.ones(6, np.float32))
            np.testing.assert_array_equal(loaded.pull_sparse("emb", ids),
                                          survivor.pull_sparse("emb", ids))
            np.testing.assert_array_equal(loaded.pull_dense("w"),
                                          survivor.pull_dense("w"))
            never = np.array([77], np.int64)  # the init seeds came back
            np.testing.assert_array_equal(loaded.pull_sparse("emb", never),
                                          survivor.pull_sparse("emb", never))
        finally:
            _close([loaded], fresh)
        one, one_eps = _cluster(load_pkg, n=1)
        single = load_pkg.PsClient(one_eps)
        try:
            with pytest.raises(RuntimeError, match="shard 0 of 2"):
                single.load_tables(snap)
        finally:
            _close([single], one)
    finally:
        _close([survivor], survivor_servers)


def test_rejoining_worker_cannot_clobber_a_live_table():
    servers, eps = _cluster(PS)
    client = PS.PsClient(eps)
    try:
        client.create_dense("w", 4, "sgd", 1.0, init=np.zeros(4, np.float32))
        client.push_dense("w", np.ones(4, np.float32))
        client.create_dense("w", 4, "sgd", 1.0,
                            init=np.full(4, 7.0, np.float32))
        np.testing.assert_array_equal(client.pull_dense("w"), -1.0)
    finally:
        _close([client], servers)


def test_barrier_holds_until_every_worker():
    servers, eps = _cluster(PS, n=1, n_workers=2)
    c1, c2 = PS.PsClient(eps), RS.PsClient(eps)  # one of each package
    released = []
    th = threading.Thread(target=lambda: (c1.barrier(),
                                          released.append(1)))
    th.start()
    th.join(timeout=0.3)
    assert th.is_alive() and not released
    c2.barrier()
    th.join(timeout=JOIN_S)
    assert not th.is_alive() and released == [1]
    _close([c1, c2], servers)
