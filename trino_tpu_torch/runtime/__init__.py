"""Distributed runtime: workers, tasks, buffers, exchange, scheduling.

Counterpart of trino_tpu/runtime/ (the coordinator/worker split: a host
control plane around the device data plane). The in-process form, N
Workers on threads in one process sharing one card, is the
DistributedQueryRunner topology; its task threads plan their fragments
on the worker's device and launch the port's CUDA kernels. The wire
form puts each Worker behind a WorkerServer (http.py: typed spec JSON
from codec.py, pages pulled as serde bytes); retry_policy="task" runs
fte.py over the spooled exchange (spool.py); the front door is
server.py with resource_groups.py; the query memory pool is memory.py.

The package's names load on first use, so a module that counts through
runtime/metrics.py does not pull in the coordinator.
"""

__all__ = ["OutputBuffer", "DistributedQueryRunner", "Worker"]


def __getattr__(name):
    if name == "OutputBuffer":
        from trino_tpu_torch.runtime.buffers import OutputBuffer

        return OutputBuffer
    if name == "DistributedQueryRunner":
        from trino_tpu_torch.runtime.coordinator import DistributedQueryRunner

        return DistributedQueryRunner
    if name == "Worker":
        from trino_tpu_torch.runtime.worker import Worker

        return Worker
    raise AttributeError(name)
