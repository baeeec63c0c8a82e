"""The port's parameter-server runtime (``paddle_tpu_torch.distributed.ps``:
``DistEmbedding``, ``ThePS``, ``GeoSGD``, the communicator, the role
makers, ``fleet``'s PS mode, the ``--run_mode ps`` launcher) against the
JAX package's, on the CPU:

- the whole slice: a Criteo-shaped DNN at small widths (4 sparse slots in
  one ``DistEmbedding`` of dimension 4, 3 dense features, layers 16 and
  8, then 1, sigmoid cross-entropy) trains 15 steps of sync ``ThePS`` in
  each package, each against its own two in-process servers with the same
  seeds and the reference's initial weights: losses, dense tables and
  touched rows within 1e-5;
- Geo-SGD's delta merge (two workers) and the async communicator's merge
  (dense summed, sparse summed by id) give the reference's tables; retries
  ride out transient failures; async ``ThePS`` converges with its fresh
  values rebound on the same ``Parameter`` objects, nothing written in
  place;
- the role makers read the launcher's environment as the reference's do;
  ``fleet.init(role, is_collective=False)`` serves and saves;
- ``PSController``'s servers and trainers get the reference's
  environment, and one launch of ``python -m
  paddle_tpu_torch.distributed.launch --run_mode ps`` (two servers, two
  trainers, the CPU) trains to its end.
"""
import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.distributed.ps import communicator as RC
from paddle_tpu.distributed.ps import role_maker as RR
from paddle_tpu.distributed.ps import runtime as RP
from paddle_tpu.distributed.ps import service as RS
from paddle_tpu_torch import _device
from paddle_tpu_torch.distributed.ps import communicator as PC
from paddle_tpu_torch.distributed.ps import role_maker as PR
from paddle_tpu_torch.distributed.ps import runtime as PP
from paddle_tpu_torch.distributed.ps import service as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
SLOTS, DIM, DENSE, WIDTHS, BATCH, STEPS = 4, 4, 3, (16, 8), 16, 15
LAUNCH_TIMEOUT_S = 120
JOIN_S = 10.0


@pytest.fixture
def _cpu():
    prev = _device._CURRENT
    T.set_device("cpu")
    yield
    _device._CURRENT = prev


@pytest.fixture
def clusters(monkeypatch):
    """``make(n)``: a fresh set of in-process servers of each package with
    a client of each, bound as each runtime's worker 0."""
    made = []

    def make(n=2):
        out = {}
        for key, S, R, RM in (("ref", RS, RP, RR), ("port", PS, PP, PR)):
            servers = [S.PsServer(port=0, n_workers=1,
                                  host="127.0.0.1").start()
                       for _ in range(n)]
            eps = [f"127.0.0.1:{s.port}" for s in servers]
            R.set_role(RM.UserDefinedRoleMaker(server_endpoints=eps))
            client = S.PsClient(eps)
            monkeypatch.setattr(R, "_client", client)
            made.append((client, servers))
            out[key] = client
        return out

    yield make
    for client, servers in made:
        client.close()
        for s in servers:
            s.stop()
    PP.set_role(None)
    RP.set_role(None)


def ctr_dnn(P, R, name="emb"):
    """The Criteo-shaped DNN in package ``P`` with its runtime ``R``."""

    class CtrDnn(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = R.DistEmbedding(name, 1000, DIM, lr=0.05)
            widths = (SLOTS * DIM + DENSE,) + WIDTHS + (1,)
            self.fcs = P.nn.LayerList([P.nn.Linear(a, b) for a, b in
                                       zip(widths[:-1], widths[1:])])

        def forward(self, ids, dense):
            e = P.reshape(self.emb(ids), [ids.shape[0], SLOTS * DIM])
            h = P.concat([e, dense], axis=1)
            for fc in self.fcs[:-1]:
                h = P.nn.functional.relu(fc(h))
            return self.fcs[-1](h)

    return CtrDnn()


def ctr_batches(seed=0):
    rs = np.random.RandomState(seed)
    hidden = rs.randn(DENSE).astype(np.float32)
    out = []
    for _ in range(STEPS):
        ids = np.minimum(rs.zipf(1.3, (BATCH, SLOTS)), 999).astype(np.int64)
        dense = rs.rand(BATCH, DENSE).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-(dense @ hidden + (ids[:, 0] % 2) - 0.5)))
        label = (rs.rand(BATCH) < p).astype(np.float32)[:, None]
        out.append((ids, dense, label))
    return out


def _train(P, R, net, ps, batches):
    losses = []
    for ids, dense, label in batches:
        logit = net(P.to_tensor(ids), P.to_tensor(dense))
        loss = P.nn.functional.binary_cross_entropy_with_logits(
            logit, P.to_tensor(label))
        loss.backward()
        ps.step()
        losses.append(float(loss.numpy()))
    return losses


def test_criteo_dnn_sync_the_ps_matches_the_reference(_cpu, clusters):
    c = clusters()
    J.seed(5)
    RP._client = c["ref"]
    ref = ctr_dnn(J, RP)
    PP._client = c["port"]
    port = ctr_dnn(T, PP)
    res = port.set_state_dict({k: v.numpy()
                               for k, v in ref.state_dict().items()})
    assert res == ([], [])
    names = [n for n, _ in port.named_parameters()]
    assert names == [n for n, _ in ref.named_parameters()]
    ref_ps = RP.ThePS(ref, dense_optimizer="sgd", dense_lr=0.05)
    port_ps = PP.ThePS(port, dense_optimizer="sgd", dense_lr=0.05)
    batches = ctr_batches()
    want = _train(J, RP, ref, ref_ps, batches)
    params = [id(p) for p in port.parameters()]
    got = _train(T, PP, port, port_ps, batches)
    assert [id(p) for p in port.parameters()] == params  # rebound in place
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert got[-1] < got[0]
    for n in names:  # the servers' dense tables
        np.testing.assert_allclose(c["port"].pull_dense(n),
                                   c["ref"].pull_dense(n), rtol=TOL,
                                   atol=TOL)
    touched = np.unique(np.concatenate([b[0].ravel() for b in batches]))
    np.testing.assert_allclose(c["port"].pull_sparse("emb", touched),
                               c["ref"].pull_sparse("emb", touched),
                               rtol=TOL, atol=TOL)
    assert c["port"].sparse_size("emb") == c["ref"].sparse_size("emb") \
        == touched.size
    assert port.emb.pulled_rows == port.emb.pushed_rows \
        == STEPS * BATCH * SLOTS


def test_geo_sgd_merges_deltas_as_the_reference(_cpu, clusters):
    c = clusters()
    out = {}
    J.seed(7)
    init = {k: v.numpy() for k, v in J.nn.Linear(4, 3).state_dict().items()}
    for key, P, R in (("ref", J, RP), ("port", T, PP)):
        R._client = c[key]
        m_a, m_b = P.nn.Linear(4, 3), P.nn.Linear(4, 3)
        m_a.set_state_dict(init)
        m_b.set_state_dict(init)
        init_w = m_a.weight.numpy().copy()
        geo_a = R.GeoSGD(m_a, k_steps=2)
        geo_b = R.GeoSGD(m_b, k_steps=2)
        if key == "ref":
            m_a.weight._value = m_a.weight._value + 0.5
        else:
            with torch.no_grad():
                m_a.weight.add_(0.5)
        geo_a.step()  # no sync yet
        geo_a.step()  # sync: +0.5
        if key == "ref":
            m_b.weight._value = m_b.weight._value + 0.25
        else:
            with torch.no_grad():
                m_b.weight.add_(0.25)
        geo_b.sync()
        np.testing.assert_allclose(m_b.weight.numpy(), init_w + 0.75,
                                   rtol=TOL)
        geo_a.sync()
        np.testing.assert_array_equal(m_a.weight.numpy(),
                                      m_b.weight.numpy())
        out[key] = (init_w, m_a.weight.numpy(), c[key].pull_dense(
            geo_a._dense[0][0]))
    np.testing.assert_array_equal(out["ref"][0], out["port"][0])
    np.testing.assert_array_equal(out["ref"][1], out["port"][1])
    np.testing.assert_array_equal(out["ref"][2], out["port"][2])


def test_async_merge_sums_by_id_as_the_reference(clusters):
    c = clusters()
    got = {}
    for key, C in (("ref", RC), ("port", PC)):
        client = c[key]
        client.create_dense("w", 4, "sgd", 1.0, init=np.zeros(4, np.float32))
        client.create_sparse("emb", 4, "sgd", 1.0, seed=0)
        base = client.pull_sparse("emb", np.array([1, 2, 3]))
        comm = C.AsyncCommunicator(client, send_interval=0.05).start()
        for _ in range(8):
            comm.push_dense("w", np.ones(4, np.float32))
        comm.push_sparse("emb", np.array([1, 2]), np.ones((2, 4), np.float32))
        comm.push_sparse("emb", np.array([2, 3, 2]),
                         np.full((3, 4), 0.5, np.float32))
        comm.flush()
        comm.stop()
        assert comm.merged_grads == 10 and comm.dropped_batches == 0
        assert comm.last_error is None
        after = client.pull_sparse("emb", np.array([1, 2, 3]))
        np.testing.assert_allclose(after - base, [[-1.0] * 4, [-2.0] * 4,
                                                  [-0.5] * 4], atol=1e-6)
        got[key] = (client.pull_dense("w"), after)
    np.testing.assert_array_equal(got["port"][0], -8.0)
    np.testing.assert_array_equal(got["ref"][1], got["port"][1])


def test_async_retries_transient_failures(clusters):
    client = clusters()["port"]
    client.create_dense("w", 2, "sgd", 1.0, init=np.zeros(2, np.float32))
    comm = PC.AsyncCommunicator(client, send_interval=0.001, retry=3,
                                retry_backoff=0.01)
    fails = {"n": 2}
    real = client.push_dense

    def flaky(name, grad, apply_now=True):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise ConnectionError("injected transient failure")
        return real(name, grad, apply_now)

    client.push_dense = flaky
    comm.start()
    comm.push_dense("w", np.ones(2, np.float32))
    comm.flush()
    comm.stop()
    np.testing.assert_array_equal(client.pull_dense("w"), -1.0)
    assert fails["n"] == 0 and comm.dropped_batches == 0


def test_async_the_ps_converges_and_rebinds(_cpu, clusters):
    PP._client = clusters()["port"]
    T.seed(7)

    class SparseNet(T.nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = PP.DistEmbedding("v2", 50, 8, lr=0.2)
            self.fc = T.nn.Linear(8, 1)

        def forward(self, ids):
            return self.fc(T.mean(self.emb(ids), axis=1))

    net = SparseNet()
    ps = PP.ThePS(net, dense_optimizer="sgd", dense_lr=0.1, mode="async")
    ps.communicator._pull_interval = 0.005
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 50, (16, 3))
    target = (ids.mean(axis=1, keepdims=True) / 25.0 - 1.0).astype("float32")
    weight = net.fc.weight
    version = weight._version
    losses = []
    for _ in range(25):
        loss = T.mean((net(T.to_tensor(ids)) - T.to_tensor(target)) ** 2)
        loss.backward()
        ps.step()
        losses.append(float(loss.numpy()))
        time.sleep(0.01)
    comm = ps.communicator
    ps.flush()
    assert comm.dropped_batches == 0 and comm.last_error is None
    assert comm.refreshes > 0  # the receive thread's values were rebound
    assert net.fc.weight is weight and weight._version == version
    ps.stop()
    assert losses[-1] < losses[0] * 0.6, losses


def test_the_first_workers_values_reach_the_tables(_cpu, monkeypatch):
    """Two workers, the other one first: its ThePS waits at the barrier
    and the tables hold the first worker's values (the reference lets
    the other one create them as zeros first)."""
    servers = [PS.PsServer(port=0, n_workers=2, host="127.0.0.1").start()
               for _ in range(2)]
    eps = [f"127.0.0.1:{s.port}" for s in servers]
    clients = {"first": PS.PsClient(eps), "other": PS.PsClient(eps)}
    who = threading.local()
    monkeypatch.setattr(PP, "get_ps_client", lambda: clients[who.name])
    monkeypatch.setattr(PP.ThePS, "_is_owner",
                        lambda self: who.name == "first")
    monkeypatch.setattr(PP, "_get_role", lambda: PR.UserDefinedRoleMaker(
        current_id=0 if who.name == "first" else 1, worker_num=2,
        server_endpoints=eps))
    nets, errors = {}, []

    def worker(name, seed, cls):
        who.name = name
        try:
            T.seed(seed)
            net = T.nn.Linear(4, 3)
            nets[name] = (net, cls(net))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    for cls in (PP.ThePS, lambda n: PP.GeoSGD(n, k_steps=2)):
        other = threading.Thread(target=worker, args=("other", 2, cls))
        other.start()
        other.join(timeout=0.5)
        assert other.is_alive()  # held at the barrier
        worker("first", 1, cls)
        other.join(timeout=JOIN_S)
        assert not other.is_alive() and not errors
        want = nets["first"][0].weight.detach().numpy()
        assert np.abs(want).sum() > 0
        np.testing.assert_array_equal(
            nets["other"][0].weight.detach().numpy(), want)
        for s in servers:  # fresh tables for the next case
            s._dense.clear()
    for c in clients.values():
        c.close()
    for s in servers:
        s.stop()


ENV = {"TRAINING_ROLE": "PSERVER", "PADDLE_PSERVERS_IP_PORT_LIST":
       "10.0.0.1:6000,10.0.0.2:6001", "PADDLE_TRAINERS_NUM": "3",
       "PADDLE_RANK": "1", "PADDLE_TRAINER_ID": "2", "PADDLE_PORT": "6001"}


@pytest.mark.parametrize("role", ["PSERVER", "TRAINER", None])
def test_role_makers_read_the_references_environment(monkeypatch, role):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    if role is None:
        monkeypatch.delenv("TRAINING_ROLE")
    else:
        monkeypatch.setenv("TRAINING_ROLE", role)
    asks = ("is_worker", "is_server", "is_first_worker", "worker_index",
            "server_index", "worker_num", "server_num",
            "get_pserver_endpoints")
    for make in (lambda M: M.PaddleCloudRoleMaker(),
                 lambda M: M.UserDefinedRoleMaker(
                     current_id=0, role=M.Role.WORKER, worker_num=2,
                     server_endpoints=["a:1"])):
        r, p = make(RR), make(PR)
        assert [getattr(r, a)() for a in asks] == \
            [getattr(p, a)() for a in asks]
        assert r._port == p._port
    assert (PR.Role.WORKER, PR.Role.SERVER, PR.Role.HETER_WORKER) == \
        (RR.Role.WORKER, RR.Role.SERVER, RR.Role.HETER_WORKER)


def test_fleet_ps_mode_serves_saves_and_stops(_cpu, tmp_path):
    from paddle_tpu_torch.distributed.fleet import Fleet

    server_fleet = Fleet().init(PR.UserDefinedRoleMaker(
        role=PR.Role.SERVER, worker_num=1,
        server_endpoints=["127.0.0.1:0"]), is_collective=False)
    assert server_fleet.is_server() and not server_fleet.is_worker()
    server = server_fleet.init_server()
    th = threading.Thread(target=server_fleet.run_server, daemon=True)
    th.start()
    worker = Fleet().init(PR.UserDefinedRoleMaker(
        current_id=0, worker_num=1,
        server_endpoints=[f"127.0.0.1:{server.port}"]), is_collective=False)
    assert worker.is_worker() and worker.is_first_worker()
    assert (worker.worker_index(), worker.worker_num()) == (0, 1)
    client = worker.init_worker()
    try:
        client.create_dense("w", 3, "sgd", 0.5, init=np.ones(3, np.float32))
        worker.barrier_worker()
        assert worker.save_persistables(dirname=str(tmp_path / "s")) == 1
        client.push_dense("w", np.ones(3, np.float32))
        assert worker.load_persistables(dirname=str(tmp_path / "s")) == 1
        np.testing.assert_array_equal(client.pull_dense("w"), 1.0)
    finally:
        worker.stop_worker()  # worker 0 stops the server
    th.join(timeout=10)
    assert not th.is_alive()
    server.stop()
    PP.set_role(None)


def _ps_pod(pkg, monkeypatch, argv):
    import importlib

    ctx_mod = importlib.import_module(f"{pkg}.distributed.launch.context")
    ctl_mod = importlib.import_module(f"{pkg}.distributed.launch.controller")
    monkeypatch.setattr(ctx_mod, "_local_ip", lambda: "10.1.2.3")
    ports = itertools.count(7000)
    monkeypatch.setattr(ctx_mod.Node, "get_free_port",
                        lambda self: next(ports))
    ctrl = ctl_mod.PSController(ctx_mod.Context(argv))
    ctrl.build_ps_pod()
    return [(c.entrypoint, c.env, c.log_path) for c in ctrl.pod.containers]


@pytest.mark.parametrize("argv", [
    ["--run_mode", "ps", "--server_num", "2", "--trainer_num", "2",
     "train.py", "--lr", "0.1"],
    ["--run_mode", "ps", "--server_num", "1", "--trainer_num", "3",
     "--job_id", "j9", "--log_dir", "logs", "train.py"]],
    ids=["two_two", "one_three"])
def test_ps_controller_environment_is_the_references(monkeypatch, argv):
    want = _ps_pod("paddle_tpu", monkeypatch, argv)
    got = _ps_pod("paddle_tpu_torch", monkeypatch, argv)
    assert got == want
    roles = [env["TRAINING_ROLE"] for _, env, _ in got]
    n_servers = int(argv[argv.index("--server_num") + 1])
    assert roles.count("PSERVER") == n_servers


TRAINER = r'''
import json, os, sys
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.ps import runtime

paddle.set_device("cpu")
out_dir = sys.argv[1]
f = fleet.fleet.init(fleet.PaddleCloudRoleMaker(), is_collective=False)
if f.is_server():
    f.init_server()
    f.run_server()
    sys.exit(0)
f.init_worker()
paddle.seed(3)


class Net(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = runtime.DistEmbedding("emb", 100, 4)
        self.fc = paddle.nn.Linear(4, 1)

    def forward(self, ids):
        return self.fc(paddle.mean(self.emb(ids), axis=1))


net = Net()
ps = runtime.ThePS(net, dense_lr=0.1)
rs = np.random.RandomState(f.worker_index())
losses = []
for _ in range(4):
    ids = rs.randint(0, 100, (8, 3))
    loss = paddle.mean(net(paddle.to_tensor(ids)) ** 2)
    loss.backward()
    ps.step()
    losses.append(float(loss.numpy()))
f.barrier_worker()
with open(os.path.join(out_dir, f"trainer{f.worker_index()}.json"), "w") as fh:
    json.dump({"losses": losses, "first": f.is_first_worker(),
               "rows": runtime.get_ps_client().sparse_size("emb")}, fh)
f.stop_worker()
'''


def test_launch_run_mode_ps_trains(tmp_path):
    script = tmp_path / "trainer.py"
    script.write_text(TRAINER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), PADDLE_PS_BIND_HOST="127.0.0.1")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--run_mode", "ps", "--server_num", "2", "--trainer_num", "2",
         "--log_dir", str(tmp_path / "log"), str(script), str(tmp_path)],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    logs = {n: (tmp_path / "log" / n).read_text()[-2000:]
            for n in sorted(os.listdir(tmp_path / "log"))}
    assert proc.returncode == 0, (proc.stderr[-2000:], logs)
    assert sorted(logs) == ["serverlog.0", "serverlog.1", "workerlog.0",
                            "workerlog.1"]
    res = [json.loads((tmp_path / f"trainer{i}.json").read_text())
           for i in range(2)]
    assert [r["first"] for r in res] == [True, False]
    assert all(len(r["losses"]) == 4 and np.isfinite(r["losses"]).all()
               for r in res)
    assert res[0]["rows"] == res[1]["rows"] > 0
