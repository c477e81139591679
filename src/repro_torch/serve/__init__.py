"""Greedy paged serving of the port: the session engine and its records.

See :mod:`repro_torch.serve.engine` for the session contract (submit /
tick / drain / run), :mod:`.scheduler` for admission policy and
:mod:`.allocator` for page accounting; a preempted request waits on the
swap queue as a :class:`SwappedRequest`.
"""
from repro_torch.serve.config import Request, ServeConfig  # noqa: F401
from repro_torch.serve.engine import (RequestHandle,  # noqa: F401
                                      ServingEngine)
from repro_torch.serve.scheduler import SwappedRequest  # noqa: F401
