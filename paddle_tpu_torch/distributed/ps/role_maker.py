"""Role makers for parameter-server jobs — the port of
``paddle_tpu/distributed/ps/role_maker.py``, a copy.

Reference: python/paddle/distributed/fleet/base/role_maker.py
(PaddleCloudRoleMaker) — parses TRAINING_ROLE / PADDLE_PSERVERS_IP_PORT_LIST /
PADDLE_TRAINER_ID envs set by the launch CLI's PS controller
(launch/controller.py build_ps_pod).
"""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "").split(",")
            if e]
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._current_id = int(os.environ.get(
            "PADDLE_RANK" if self._role == Role.SERVER else "PADDLE_TRAINER_ID",
            "0"))
        self._port = int(os.environ.get("PADDLE_PORT", "0"))

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints)

    def get_pserver_endpoints(self):
        return list(self._server_endpoints)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """Role assignment from explicit arguments instead of env vars
    (reference: fleet/base/role_maker.py UserDefinedRoleMaker). Overrides the
    instance attributes the base class's public accessors read."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=1, server_endpoints=None, **kwargs):
        super().__init__(is_collective=is_collective, **kwargs)
        self._role = role
        self._current_id = int(current_id)
        self._worker_num = int(worker_num)
        self._server_endpoints = list(server_endpoints or [])
