"""The parameter-server runtime — the port of
``paddle_tpu/distributed/ps/runtime.py``: the fleet-style server and
worker lifecycle, ``DistEmbedding``, ``ThePS`` and ``GeoSGD``.

Reference: python/paddle/distributed/fleet/runtime/the_one_ps.py
(TheOnePSRuntime) and the distributed lookup table. The sparse table and
every dense parameter live on the servers, host processes; the dense
math runs on the card. A step (sync):

1. ``DistEmbedding.forward`` pulls the rows of the batch's ids to the
   host and copies them onto the card as a leaf that requires a
   gradient (reshaped after it is recorded);
2. after ``loss.backward()``, ``ThePS.step()`` pushes each lookup's row
   gradients (float32 numpy, with their ids) and each dense parameter's
   gradient; the servers apply SGD or Adagrad natively, and the fresh
   dense values come back.

Fresh values never go into a parameter's tensor: ``rebind`` gives the
same ``Parameter`` object a fresh tensor on its device (its ``data``),
so a tensor autograd saved is never written. In async mode the
communicator stages the fresh tensors and ``ThePS.step`` rebinds them
(``communicator.py`` says why).
"""
from __future__ import annotations

import numpy as np
import torch

from ..._device import resolve_device
from ...nn.layer import Layer
from .role_maker import PaddleCloudRoleMaker
from .service import PsClient, PsServer

__all__ = ["get_ps_client", "set_role", "init_server", "run_server",
           "init_worker", "barrier_worker", "stop_worker", "rebind",
           "DistEmbedding", "ThePS", "GeoSGD"]

_client: PsClient | None = None
_server: PsServer | None = None
_role: PaddleCloudRoleMaker | None = None


def get_ps_client() -> PsClient:
    if _client is None:
        raise RuntimeError("call init_worker() first")
    return _client


def _get_role() -> PaddleCloudRoleMaker:
    global _role
    if _role is None:
        _role = PaddleCloudRoleMaker()
    return _role


def set_role(role):
    global _role
    _role = role


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy of ``t`` on the host (what the wire takes)."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def rebind(param: torch.Tensor, values: np.ndarray) -> None:
    """``param``'s data becomes a fresh tensor on its device and in its
    dtype holding ``values`` (any shape of the same size)."""
    param.data = torch.from_numpy(np.ascontiguousarray(values).reshape(
        tuple(param.shape))).to(param.device, param.dtype)


# ---------------------------------------------------------------- lifecycle
def init_server(role=None, n_workers=None):
    """Create this rank's PsServer on PADDLE_PORT (reference:
    fleet.init_server)."""
    global _server
    role = role or _get_role()
    eps = role.get_pserver_endpoints()
    host = None
    if eps and 0 <= role.server_index() < len(eps):
        host = eps[role.server_index()].split(":")[0]  # bind the advertised NIC
    _server = PsServer(port=role._port, n_workers=n_workers or role.worker_num(),
                       host=host)
    return _server


def run_server(block=True):
    """Serve until a worker sends stop (reference: fleet.run_server)."""
    if _server is None:
        raise RuntimeError("call init_server() first")
    _server.start(block=block)
    return _server


def init_worker(role=None):
    """Connect to all PS shards (reference: fleet.init_worker)."""
    global _client
    role = role or _get_role()
    _client = PsClient(role.get_pserver_endpoints())
    return _client


def barrier_worker():
    get_ps_client().barrier()


def stop_worker():
    """Last barrier, then worker 0 shuts the servers down."""
    global _client
    if _client is None:
        return
    role = _get_role()
    _client.barrier()
    if role.is_first_worker():
        _client.stop_servers()
    _client.close()
    _client = None


# ---------------------------------------------------------------- layers
class DistEmbedding(Layer):
    """An embedding whose table lives on the parameter servers.

    The rows land on the device of ``ids`` when it is a tensor, else on
    ``set_device``'s (the card unless the caller chose the CPU).
    ``pulled_rows`` / ``pushed_rows`` count the rows that crossed the
    wire, duplicates included, as the reference sends them.
    """

    def __init__(self, name, num_embeddings, embedding_dim, optimizer="adagrad",
                 lr=0.05):
        super().__init__()
        self.table_name = name
        self.embedding_dim = embedding_dim
        self._lookups = []  # every forward's (ids, rows_tensor) this step
        self.pulled_rows = 0
        self.pushed_rows = 0
        get_ps_client().create_sparse(name, embedding_dim, optimizer, lr)

    def forward(self, ids):
        if isinstance(ids, torch.Tensor):
            device = ids.device
            ids_np = ids.detach().cpu().numpy().astype(np.int64)
        else:
            device = resolve_device(None)
            ids_np = np.asarray(ids, np.int64)
        flat = ids_np.reshape(-1)
        rows = get_ps_client().pull_sparse(self.table_name, flat)
        self.pulled_rows += flat.size
        track = torch.is_grad_enabled() and self.training
        t = torch.from_numpy(rows).to(device)
        if track:
            # shared-table multi-lookup safe; eval/no_grad forwards don't
            # accumulate (nothing will ever push their grads)
            t.requires_grad_()
            self._lookups.append((flat, t))
        return t.reshape(list(ids_np.shape) + [self.embedding_dim])

    def _take_grads(self):
        """The recorded lookups' ``(ids, row gradients)``; clears them."""
        out = [(ids, _host(t.grad)) for ids, t in self._lookups
               if t.grad is not None]
        self._lookups.clear()
        self.pushed_rows += sum(ids.size for ids, _ in out)
        return out

    def push_grads(self):
        for ids, g in self._take_grads():
            get_ps_client().push_sparse(self.table_name, ids, g)


class ThePS:
    """Worker-side coordinator: registers dense params + DistEmbeddings,
    runs the pull/push cycle (reference: TheOnePSRuntime).

    mode="sync": step() pushes and pulls inline (a_sync off).
    mode="async": step() only ENQUEUES grads into an AsyncCommunicator
    — a send thread merges and ships them, a receive thread stages fresh
    dense values that step() rebinds; the trainer never blocks on the PS.
    `barrier=False` lets a restarted worker (fault recovery) rejoin without
    a rendezvous the surviving workers would never re-enter.
    Dense tables are keyed by ``named_parameters()`` name and hold the
    flattened parameter (Linear weights in the reference's ``[in, out]``).
    With the barrier, only the first worker creates them, with its
    values, before it: the reference lets every worker create, so a
    worker that comes first makes zero tables that the first worker's
    values then never enter.
    """

    def __init__(self, model: Layer, dense_optimizer="sgd", dense_lr=0.01,
                 mode="sync", barrier=True):
        self.model = model
        self.client = get_ps_client()
        self.mode = mode
        self._dense: list[tuple[str, torch.Tensor]] = []
        self._embeddings: list[DistEmbedding] = []
        for _, sub in [("", model)] + list(model.named_sublayers()):
            if isinstance(sub, DistEmbedding):
                self._embeddings.append(sub)
        owner = self._is_owner()
        for pname, p in model.named_parameters():
            self._dense.append((pname, p))
            if owner or not barrier:
                self.client.create_dense(pname, int(np.prod(p.shape)),
                                         dense_optimizer, dense_lr,
                                         init=_host(p).reshape(-1)
                                         if owner else None)
        if barrier:
            self.client.barrier()  # all tables exist before training
        self.pull_dense()
        self._comm = None
        if mode == "async":
            from .communicator import AsyncCommunicator

            self._comm = AsyncCommunicator(self.client)
            for name, p in self._dense:
                self._comm.register_dense(name, p)
            self._comm.start()

    @property
    def communicator(self):
        """The async mode's ``AsyncCommunicator`` (None in sync mode)."""
        return self._comm

    def _is_owner(self):
        return _get_role().is_first_worker()

    def pull_dense(self):
        """Refresh local dense params from the servers."""
        for name, p in self._dense:
            rebind(p, self.client.pull_dense(name))

    def step(self):
        """Push grads (sparse + dense). sync: server applies + fresh pull
        inline; async: enqueue only (communicator threads do the rest),
        then rebind what the receive thread staged."""
        if self._comm is not None:
            for emb in self._embeddings:
                for ids, g in emb._take_grads():
                    self._comm.push_sparse(emb.table_name, ids, g)
            for name, p in self._dense:
                if p.grad is not None:
                    self._comm.push_dense(name, _host(p.grad).reshape(-1))
            self.model.clear_gradients()
            self._comm.refresh()
            return
        for emb in self._embeddings:
            emb.push_grads()
        for name, p in self._dense:
            if p.grad is not None:
                self.client.push_dense(name, _host(p.grad).reshape(-1),
                                       apply_now=True)
        self.model.clear_gradients()
        self.pull_dense()

    def flush(self):
        """Drain the async send queue (no-op in sync mode)."""
        if self._comm is not None:
            self._comm.flush()
            self._comm.refresh()
            self.pull_dense()

    def stop(self):
        if self._comm is not None:
            self._comm.stop()
            self._comm = None


class GeoSGD:
    """Geo-SGD communication mode (reference: the_one_ps.py geo mode +
    GeoCommunicator — strategy.a_sync_configs["k_steps"] > 0).

    Workers train fully locally with their own optimizer; every `k_steps`
    local steps the worker pushes the parameter DELTA (local - last-synced)
    to the servers, which accumulate deltas from all workers, then pulls the
    merged result back. Decouples workers for high-latency clusters at the
    cost of bounded staleness.
    """

    def __init__(self, model: Layer, k_steps: int = 100):
        self.model = model
        self.k_steps = int(k_steps)
        self.client = get_ps_client()
        self._dense: list[tuple[str, torch.Tensor]] = []
        self._base: dict[str, np.ndarray] = {}
        self._count = 0
        owner = _get_role().is_first_worker()
        for pname, p in model.named_parameters():
            if not p.requires_grad:
                continue
            self._dense.append((pname, p))
            # geo table: plain accumulation -> create with sgd lr=1.0 and push
            # the negated delta (server does p -= lr * grad); the first
            # worker alone creates it, with its values, as in ThePS
            if owner:
                self.client.create_dense(pname, int(np.prod(p.shape)),
                                         "sgd", 1.0,
                                         init=_host(p).reshape(-1))
        self.client.barrier()
        self._pull_and_rebase()

    def _pull_and_rebase(self):
        for name, p in self._dense:
            vals = self.client.pull_dense(name)
            rebind(p, vals)
            self._base[name] = vals.copy()

    def step(self):
        """Call once per LOCAL optimizer step; syncs every k_steps."""
        self._count += 1
        if self._count % self.k_steps == 0:
            self.sync()

    def sync(self):
        for name, p in self._dense:
            delta = _host(p).reshape(-1) - self._base[name]
            self.client.push_dense(name, -delta, apply_now=True)
        self._pull_and_rebase()
