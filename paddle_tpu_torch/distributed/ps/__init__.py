"""paddle_tpu_torch.distributed.ps — the parameter-server training
stack, the port of ``paddle_tpu/distributed/ps``.

Reference analog: `paddle/fluid/distributed/ps/` — brpc-based
PsServer/PsClient, memory dense/sparse tables, accessors, and the python
runtime `the_one_ps.py`.

What the parameter server holds is *parameter storage + update*: huge
sparse embeddings (and, in this mode, the dense parameters too) live on
host server processes, while the dense math runs on the card. Tables are
native C++ (``csrc/ps_table.cc``: sharded hash maps, server-side
SGD/Adagrad, off the interpreter lock; ``tables.native_tables()`` says
whether it is in use) with the reference's numpy fallback; the transport
is the reference's length-prefixed pickle protocol over sockets, so a
port process and a reference process serve each other; workers pull rows
and push gradients in sync, async (``communicator``) or geo mode.
"""
from .tables import (CtrAccessor, DenseTable, SparseTable, SsdSparseTable,
                     native_tables)
from .service import PsServer, PsClient
from .role_maker import PaddleCloudRoleMaker, Role
from .runtime import (GeoSGD, ThePS, DistEmbedding, barrier_worker,
                      get_ps_client, init_server, init_worker, run_server,
                      stop_worker)

__all__ = ["CtrAccessor", "DenseTable", "SparseTable", "SsdSparseTable",
           "native_tables", "PsServer", "PsClient", "PaddleCloudRoleMaker",
           "Role", "GeoSGD", "ThePS", "DistEmbedding", "get_ps_client",
           "init_server", "run_server", "init_worker", "stop_worker",
           "barrier_worker"]
