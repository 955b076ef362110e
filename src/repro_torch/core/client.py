"""Dual namespaces (paper §4.1.1; ``repro/core/client.py``): every worker
has a PS identity (scheduler/server/worker rank in the global job) and an
MPI identity (rank within its client's communicator). The launcher
(§4.1.2) computes the grouping; this module is the bookkeeping both sides
share.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PSName:
    role: str  # "scheduler" | "server" | "worker"
    rank: int  # rank within role

    def __str__(self) -> str:
        return f"{self.role}:{self.rank}"


@dataclass(frozen=True)
class MPIName:
    client: int  # which MPI_COMM_WORLD (client id)
    rank: int    # rank within the client communicator

    def __str__(self) -> str:
        return f"client{self.client}/rank{self.rank}"

    @property
    def is_master(self) -> bool:
        """mpi_rank == 0 talks to the servers (paper figs. 4/5)."""
        return self.rank == 0


@dataclass(frozen=True)
class WorkerIdentity:
    ps: PSName
    mpi: MPIName


def group_workers(num_workers: int, num_clients: int) -> list[WorkerIdentity]:
    """Contiguous grouping of workers into clients (launcher policy)."""
    if num_workers % num_clients:
        raise ValueError(
            f"num_workers={num_workers} not divisible by num_clients={num_clients}"
        )
    per = num_workers // num_clients
    out = []
    for w in range(num_workers):
        out.append(
            WorkerIdentity(
                ps=PSName("worker", w),
                mpi=MPIName(client=w // per, rank=w % per),
            )
        )
    return out


def masters(identities: list[WorkerIdentity]) -> list[WorkerIdentity]:
    return [w for w in identities if w.mpi.is_master]


def client_members(identities: list[WorkerIdentity], client: int) -> list[WorkerIdentity]:
    return [w for w in identities if w.mpi.client == client]
