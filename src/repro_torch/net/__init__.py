"""Real multi-process transport for the PS tier (paper §4.1;
``repro/net``).

``core/algorithms.py`` simulates the parameter-server tier in one
process. This package backs the SAME KVStore/Membership semantics with
actual inter-process communication on localhost, in PyTorch, with the
reference's frames, ops and job config — a worker or server of either
package talks to the other's:

  wire.py        length-prefixed binary frames (JSON header + payload)
                 and the PS-leg payload codec: the FlatBuffer-packed f32
                 buffer encoded per wire dtype (f32 raw / bf16 cast /
                 int8 codes+scales of the per-hop codec), on the tensor's
                 device, so the socket carries exactly
                 ``cost_model.ps_wire_nbytes``
  transport.py   ``TcpTransport`` (real sockets, one thread per
                 connection) and ``LoopbackTransport`` (same frames, same
                 codec, no sockets — the in-process reference)
  rendezvous.py  the scheduler: joining servers publish their address,
                 joining workers get their PS + MPI identity
                 (core/client.py's grouping) and the job config;
                 publishes the epoch'd live set
  kvserver.py    the server: core/kvstore.py's rules on packed buffers
                 held on the card (the elastic rule is the fused
                 ``elastic_server_flat`` kernel), plus the round
                 buffering that makes the sync barrier, the
                 barrier_timeout degraded release and membership
                 shrink/rejoin work over real sockets
  remote_kv.py   the worker-side endpoint: push/pull/pushpull/
                 elastic_exchange/barrier/register_group RPCs with the
                 faults.py retry/backoff policy applied to real deliveries
  worker.py      the worker loop for dist_sgd / dist_esgd, equal to
                 core/algorithms.py's in-process math (same grads, same
                 barrier sum order, same fused update kernels)
  problem.py     the shared train problem, so in-process and
                 multi-process runs compare the exact same functions

Every entry point runs on the card unless the caller passes
``device="cpu"`` (``--device cpu``).
"""
