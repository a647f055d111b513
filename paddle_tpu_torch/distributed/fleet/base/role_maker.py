"""Role makers (port of ``paddle_tpu/distributed/fleet/base/role_maker.py``):
this process's worker index and the number of workers, from the
launcher's ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM`` (else the joined
process group's rank and size, see ``parallel_env``)."""
from __future__ import annotations

import os

from ...parallel_env import get_rank, get_world_size


class RoleMakerBase:
    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective

    def worker_index(self):
        return int(os.environ.get("PADDLE_TRAINER_ID", get_rank()))

    def worker_num(self):
        return int(os.environ.get("PADDLE_TRAINERS_NUM", get_world_size()))


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=True, init_gloo=False, **kwargs):
        super().__init__(is_collective)
        self._kwargs = kwargs
