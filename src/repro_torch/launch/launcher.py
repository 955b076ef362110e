"""Job launcher (``repro/launch/launcher.py``; the paper's §4.1.2
LSF/bsub analogue).

The paper's launcher runs on the front-end node and is given #workers,
#servers, #clients; it starts the MXNET scheduler first, broadcasts its
address, then submits each MPI client as a separate ``bsub``'d mpirun job.

Ours emits the same structure: a JSON job spec with the scheduler
(coordinator) address, the client → slice assignment, and one launch
command per client; ``emit_scripts`` materializes them as shell scripts
(what a deployment hands to its cluster scheduler, and what
``launch/run_local.py`` spawns). #servers=0 selects pure-MPI pushpull
mode, exactly as in the paper. The commands name this package's entry
points (``repro_torch.launch.train``, ``repro_torch.net.kvserver``,
``repro_torch.net.rendezvous``); they run on the card unless the spec's
``device`` says otherwise, which the worker and server commands then
carry as ``--device``.

  python -m repro_torch.launch.launcher --workers 8 --servers 0 --clients 1 \
      --arch qwen2-0.5b --policy auto --outdir /tmp/ls
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import InitVar, dataclass, field
from typing import Optional

from repro_torch.core.client import group_workers
from repro_torch.core.comm import CollectivePolicy, filter_mirrors, resolve_policy


@dataclass(frozen=True)
class JobSpec:
    num_workers: int            # one worker == one host (slice of chips)
    num_servers: int
    num_clients: int
    arch: str
    shape: str
    mesh: str = "pod"           # "pod" | "multipod"
    scheduler_host: str = "frontend-0"
    scheduler_port: int = 9091
    chips_per_worker: int = 16
    # update rule each worker runs (sgd / adagrad / adamw); every choice
    # lowers onto the fused flat path when fused_update is set
    optimizer: str = "sgd"
    # sharded fused sync path (SyncConfig.fused_update): reduce-scatter +
    # shard-local fused optimizer + allgather instead of full allreduce
    fused_update: bool = True
    # flat elastic leg: packed FlatBuffer + one fused exchange kernel
    flat_exchange: bool = True
    bucket_bytes: int = 0       # 0 = no byte-sized bucketing
    # low-precision wire protocol every worker runs its ring hops with
    # ("f32" = full precision; "bf16"/"int8" compress the gradient,
    # param and elastic legs — threaded to --wire-dtype)
    wire_dtype: str = "f32"
    # intra-client collective every worker runs ("" = derive the way the
    # worker CLI does: psum, or ring when the wire/overlap needs explicit
    # hops — threaded to --allreduce when it differs from that derivation)
    allreduce_method: str = ""
    num_rings: int = 0          # 0 = worker default (2; overlap forces 1)
    # flat optimizer-state stream dtype ("f32" | "bf16" — threaded to
    # --state-dtype; bf16 halves AdaGrad/AdamW state bytes per device)
    state_dtype: str = "f32"
    # backward-overlapped bucketed reduce-scatter (threaded to --overlap /
    # --overlap-buckets): each schedule bucket's ring leg is issued while
    # later layers still differentiate, hiding the wire leg behind
    # backprop; needs the fused flat path
    overlap: bool = False
    overlap_buckets: int = 4
    # deterministic fault schedule every client ships with (core/faults.py
    # string form — threaded to --faults; "" = clean)
    faults: str = ""
    # sync-barrier degradation timeout in seconds (threaded to
    # --barrier-timeout; kill/drop schedules need it)
    barrier_timeout: float = 0.0  # 0 = block forever
    # how the PS tier is reached: "loopback" keeps the in-process
    # simulation (mpirun-style client commands); "tcp" emits one OS
    # process per worker plus real net/kvserver.py processes, all
    # finding each other through the rendezvous at scheduler_host:port
    transport: str = "loopback"
    # the algorithm mode a transport job runs (net/worker.py loop);
    # required for tcp, ignored for loopback ("" = in-process default)
    mode: str = ""
    # crash recovery (launch/supervisor.py): per-unit supervised-respawn
    # budget + first backoff for abnormal exits; restart@ events in the
    # fault schedule authorize scheduled respawns without charging it
    restarts: int = 0
    restart_backoff: float = 0.05
    # durable KV checkpoint cadence in releasing steps (server-side
    # snapshots via checkpoint/checkpoint.py; doubles as the workers'
    # state-parking cadence — threaded to --checkpoint-every; 0 = off)
    checkpoint_every: int = 0
    # checkpoint path the in-process train path restores from before
    # stepping (threaded to --restore; "" = fresh init)
    restore: str = ""
    # fault schedule the SERVER tier evaluates (kill@step:unit=R self-
    # kills server R right after it releases — and snapshots — step)
    server_faults: str = ""
    # torch device every worker and server process runs on (threaded to
    # --device when it is not the default "cuda")
    device: str = "cuda"
    # internal bookkeeping: the policy the mirror knobs were backfilled
    # from (dataclasses.replace passes it back so __post_init__ can tell
    # an explicitly changed mirror from one restating the previous
    # policy). Never pass it yourself.
    policy_src: Optional[CollectivePolicy] = field(
        default=None, repr=False, compare=False)
    # -- the ONE policy field (canonical; the flat knobs mirror it) --------
    policy: InitVar[Optional[CollectivePolicy]] = None

    def __post_init__(self, policy: Optional[CollectivePolicy] = None):
        flat = {
            "method": self.allreduce_method, "num_rings": self.num_rings,
            "bucket_bytes": self.bucket_bytes, "wire_dtype": self.wire_dtype,
            "overlap": self.overlap, "overlap_buckets": self.overlap_buckets,
        }
        # only knobs the caller moved off the flag sentinels (or, on a
        # replace() round-trip, off the previous policy) count as "passed"
        flat = filter_mirrors(
            flat, defaults={"method": "", "num_rings": 0, "bucket_bytes": 0,
                            "wire_dtype": "f32", "overlap": False,
                            "overlap_buckets": 4},
            prior=self.policy_src)
        # the worker-CLI derivation: psum unless the wire/overlap needs
        # explicit ring hops; two rings unless overlap pins one schedule
        base = CollectivePolicy(
            method=("ring" if (self.wire_dtype != "f32" or self.overlap)
                    else "psum"),
            num_rings=2)
        if policy is None and flat.get("overlap"):
            # historical lowering: overlap forces a single ring schedule
            flat["num_rings"] = 1
        pol = resolve_policy(policy, flat, base=base, where="JobSpec")
        object.__setattr__(self, "policy", pol)
        object.__setattr__(self, "policy_src", pol)
        object.__setattr__(self, "allreduce_method", pol.method)
        object.__setattr__(self, "num_rings", pol.num_rings)
        object.__setattr__(self, "bucket_bytes", pol.bucket_bytes or 0)
        object.__setattr__(self, "wire_dtype", pol.wire_dtype or "f32")
        object.__setattr__(self, "overlap", pol.overlap)
        object.__setattr__(self, "overlap_buckets", pol.overlap_buckets)

    def validate(self) -> None:
        if self.optimizer not in ("sgd", "adagrad", "adamw"):
            raise ValueError(
                f"optimizer must be sgd/adagrad/adamw, got {self.optimizer!r}")
        # the collective-policy guards (method/wire membership, wire ⇒
        # ring-family, overlap ⇒ ring + single-ring + no byte-bucketing,
        # overlap_buckets >= 1) live in ONE place
        self.policy.validate(where="JobSpec")
        if self.state_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"state_dtype must be f32/bf16, got {self.state_dtype!r}")
        if self.overlap and not self.fused_update:
            raise ValueError(
                "overlap=True rides the fused flat path — the staged "
                "backward hands the update one bucket-major shard buffer; "
                "drop --no-fused-update or drop --overlap")
        if self.num_workers % self.num_clients:
            raise ValueError("#workers must divide evenly into #clients")
        if self.num_servers < 0:
            raise ValueError("#servers must be >= 0")
        if self.num_servers == 0 and self.num_clients != 1:
            # pure-MPI: one COMM_WORLD, no PS tier to glue clients together
            raise ValueError("#servers=0 (pure MPI) requires #clients=1")
        if self.faults:
            from repro_torch.core.faults import FaultSchedule

            sched = FaultSchedule.parse(self.faults)  # raises on bad form
            if (sched.kinds & {"kill", "drop"} and not self.barrier_timeout
                    and self.num_servers > 0):
                raise ValueError(
                    "a kill/drop fault schedule against the sync PS "
                    "barrier needs barrier_timeout > 0 so survivors can "
                    "release it (see KVStore.barrier_timeout)")
        if self.barrier_timeout < 0:
            raise ValueError("barrier_timeout must be >= 0 (0 = none)")
        if self.restarts < 0:
            raise ValueError("restarts must be >= 0 (0 = no respawn budget)")
        if self.restart_backoff < 0:
            raise ValueError("restart_backoff must be >= 0")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0 (0 = off)")
        if self.transport != "tcp":
            wants_restart = bool(self.restarts) or bool(self.server_faults)
            if self.faults and not wants_restart:
                from repro_torch.core.faults import FaultSchedule

                wants_restart = "restart" in FaultSchedule.parse(
                    self.faults).kinds
            if wants_restart:
                raise ValueError(
                    "restart budgets, restart@ events and server fault "
                    "schedules need real OS processes the supervisor can "
                    "respawn — transport='loopback' runs every worker as "
                    "a thread inside one process, which cannot be "
                    "SIGKILLed and re-exec'd. Use transport='tcp' "
                    "(launch/run_local.py spawns the emitted scripts) or "
                    "drop restarts/server_faults/restart@ events")
        if self.server_faults:
            from repro_torch.core.faults import FaultSchedule

            server_sched = FaultSchedule.parse(self.server_faults)
            if "kill" in server_sched.kinds and self.checkpoint_every < 1:
                raise ValueError(
                    "a server kill schedule loses every parked round "
                    "unless the server snapshots durably first: set "
                    "checkpoint_every >= 1 so the respawned server can "
                    "restore_latest() and workers can replay")
        if self.transport not in ("loopback", "tcp"):
            raise ValueError(
                f"transport must be loopback/tcp, got {self.transport!r}")
        if self.transport == "tcp":
            if self.mode not in ("dist_sgd", "dist_esgd"):
                raise ValueError(
                    "transport='tcp' runs the net/worker.py loop, which "
                    "covers dist_sgd and dist_esgd — got mode="
                    f"{self.mode!r} (async/mpi modes stay in-process; "
                    "see ROADMAP)")
            if self.num_workers != self.num_clients:
                raise ValueError(
                    "transport='tcp' launches one OS process per worker "
                    "(workers_per_client == 1): set num_clients == "
                    f"num_workers (got {self.num_clients} clients for "
                    f"{self.num_workers} workers)")
            if self.num_servers < 1:
                raise ValueError(
                    "transport='tcp' is the PS tier over sockets — it "
                    "needs num_servers >= 1 (pure-MPI pushpull has no "
                    "server process to connect to)")


def build_job(spec: JobSpec) -> dict:
    spec.validate()
    idents = group_workers(spec.num_workers, spec.num_clients)
    per_client = spec.num_workers // spec.num_clients
    # flags the worker CLI would derive on its own stay off the command
    # line; only a policy that differs needs explicit --allreduce/--num-rings
    derived_method = ("ring" if (spec.wire_dtype != "f32" or spec.overlap)
                      else "psum")
    derived_rings = 1 if spec.overlap else 2
    rdzv = f"{spec.scheduler_host}:{spec.scheduler_port}"
    device_flag = f" --device {spec.device}" if spec.device != "cuda" else ""
    clients = []
    for c in range(spec.num_clients):
        members = [w for w in idents if w.mpi.client == c]
        if spec.transport == "tcp":
            # one OS process per worker (per_client == 1): no mpirun,
            # the rendezvous hands out identities and server addresses
            launch_cmd = (
                f"python -m repro_torch.launch.train "
                f"--transport tcp --rendezvous {rdzv} "
                f"--mode {spec.mode} "
                f"--client {c} --num-clients {spec.num_clients}"
                + (f" --wire-dtype {spec.wire_dtype}"
                   if spec.wire_dtype != "f32" else "")
                + (f" --faults '{spec.faults}'" if spec.faults else "")
                + (f" --barrier-timeout {spec.barrier_timeout:g}"
                   if spec.barrier_timeout else "")
                + (f" --checkpoint-every {spec.checkpoint_every}"
                   if spec.checkpoint_every else "")
                + device_flag
            )
            clients.append({
                "client_id": c,
                "pod_slice": f"pod{c}" if spec.num_clients > 1 else "pod0",
                "master_ps_rank": members[0].ps.rank,
                "workers": [
                    {"ps_rank": m.ps.rank, "mpi_rank": m.mpi.rank,
                     "host": f"tpu-host-{m.ps.rank}"}
                    for m in members
                ],
                "launch_cmd": launch_cmd,
            })
            continue
        clients.append({
            "client_id": c,
            "pod_slice": f"pod{c}" if spec.num_clients > 1 else "pod0",
            "master_ps_rank": members[0].ps.rank,
            "workers": [
                {"ps_rank": m.ps.rank, "mpi_rank": m.mpi.rank,
                 "host": f"tpu-host-{m.ps.rank}"}
                for m in members
            ],
            "launch_cmd": (
                f"mpirun -np {per_client} python -m repro_torch.launch.train "
                f"--arch {spec.arch} --shape {spec.shape} "
                f"--client {c} --num-clients {spec.num_clients} "
                f"--scheduler {spec.scheduler_host}:{spec.scheduler_port}"
                f" --optimizer {spec.optimizer}"
                + (" --fused-update" if spec.fused_update
                   else " --no-fused-update")
                + (" --flat-exchange" if spec.flat_exchange
                   else " --no-flat-exchange")
                + (f" --bucket-bytes {spec.bucket_bytes}"
                   if spec.bucket_bytes else "")
                + (f" --wire-dtype {spec.wire_dtype}"
                   if spec.wire_dtype != "f32" else "")
                + (f" --allreduce {spec.allreduce_method}"
                   if spec.allreduce_method != derived_method else "")
                + (f" --num-rings {spec.num_rings}"
                   if spec.num_rings != derived_rings else "")
                + (f" --state-dtype {spec.state_dtype}"
                   if spec.state_dtype != "f32" else "")
                + (" --overlap" if spec.overlap else "")
                + (f" --overlap-buckets {spec.overlap_buckets}"
                   if spec.overlap and spec.overlap_buckets != 4 else "")
                + (f" --faults '{spec.faults}'" if spec.faults else "")
                + (f" --barrier-timeout {spec.barrier_timeout:g}"
                   if spec.barrier_timeout else "")
                + (f" --checkpoint-every {spec.checkpoint_every}"
                   if spec.checkpoint_every else "")
                + (f" --restore {spec.restore}" if spec.restore else "")
                + device_flag
            ),
        })
    scheduler_cmd = ("python -m repro_torch.net.rendezvous"
                     if spec.transport == "tcp"
                     else "python -m repro_torch.launch.scheduler")
    return {
        "scheduler": {
            "host": spec.scheduler_host, "port": spec.scheduler_port,
            "launch_cmd": scheduler_cmd,
        },
        "servers": [
            {"ps_rank": s, "host": f"ps-host-{s}",
             **({"launch_cmd":
                 f"python -m repro_torch.net.kvserver --rank {s} "
                 f"--rendezvous {rdzv}{device_flag}"}
                if spec.transport == "tcp" else {})}
            for s in range(spec.num_servers)
        ],
        "transport": spec.transport,
        "algo_mode": spec.mode,
        "clients": clients,
        "mode": "pure_mpi" if spec.num_servers == 0 else "hybrid_ps_mpi",
        "sync": {"optimizer": spec.optimizer,
                 "fused_update": spec.fused_update,
                 "flat_exchange": spec.flat_exchange,
                 "bucket_bytes": spec.bucket_bytes,
                 "wire_dtype": spec.wire_dtype,
                 "state_dtype": spec.state_dtype,
                 "overlap": spec.overlap,
                 "overlap_buckets": spec.overlap_buckets,
                 "policy": spec.policy.to_dict(),
                 "faults": spec.faults,
                 "barrier_timeout": spec.barrier_timeout},
        "recovery": {"restarts": spec.restarts,
                     "restart_backoff": spec.restart_backoff,
                     "checkpoint_every": spec.checkpoint_every,
                     "restore": spec.restore,
                     "server_faults": spec.server_faults},
        "mesh": spec.mesh,
        "total_chips": spec.num_workers * spec.chips_per_worker,
        "spec": dataclasses.asdict(spec),
    }


def _script_body(cmd: str, *, rdzv: str, role: str, rank: int) -> str:
    """One launch script: the rendezvous env triple (exactly once each)
    then the command. The env vars are how a process started by ANY
    cluster scheduler finds its job — the command-line flags are just
    overrides."""
    return ("#!/bin/sh\n"
            f"export REPRO_RDZV_ADDR={rdzv}\n"
            f"export REPRO_ROLE={role}\n"
            f"export REPRO_RANK={rank}\n"
            + cmd + "\n")


def emit_scripts(spec: JobSpec, outdir: str) -> list[str]:
    job = build_job(spec)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    spec_path = os.path.join(outdir, "job_spec.json")
    with open(spec_path, "w") as f:
        json.dump(job, f, indent=2)
    paths.append(spec_path)
    rdzv = f"{spec.scheduler_host}:{spec.scheduler_port}"

    launch_all = ["#!/bin/sh", "# generated by repro_torch.launch.launcher", ""]
    launch_all.append("# scheduler first (listens for worker/server connects)")
    launch_all.append(f"{job['scheduler']['launch_cmd']} &")
    for s in job["servers"]:
        if spec.transport == "tcp":
            path = os.path.join(outdir, f"server_{s['ps_rank']}.sh")
            with open(path, "w") as f:
                f.write(_script_body(s["launch_cmd"], rdzv=rdzv,
                                     role="server", rank=s["ps_rank"]))
            os.chmod(path, 0o755)
            paths.append(path)
            launch_all.append(f"sh {path} &")
        else:
            launch_all.append(
                f"ssh {s['host']} python -m repro_torch.launch.server &")
    for c in job["clients"]:
        path = os.path.join(outdir, f"client_{c['client_id']}.sh")
        with open(path, "w") as f:
            f.write(_script_body(c["launch_cmd"], rdzv=rdzv, role="worker",
                                 rank=c["client_id"]))
        os.chmod(path, 0o755)
        paths.append(path)
        launch_all.append(f"sh {path} &  # bsub analogue: one job per client")
    launch_all.append("wait")
    all_path = os.path.join(outdir, "launch_all.sh")
    with open(all_path, "w") as f:
        f.write("\n".join(launch_all) + "\n")
    os.chmod(all_path, 0o755)
    paths.append(all_path)
    return paths


def parse_script(path: str) -> dict:
    """Parse an emitted client/server script back into its facts: the
    env triple and the command's flags. The round-trip test (and
    launch/run_local.py, which spawns scripts rather than re-deriving
    commands) rely on this staying in sync with ``emit_scripts``."""
    import shlex

    env: dict[str, str] = {}
    cmd = ""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("export "):
                k, _, v = line[len("export "):].partition("=")
                env[k] = v
            elif line and not line.startswith("#"):
                cmd = line
    flags: dict[str, str] = {}
    toks = shlex.split(cmd)
    for i, tok in enumerate(toks):
        if tok.startswith("--"):
            val = (toks[i + 1]
                   if i + 1 < len(toks) and not toks[i + 1].startswith("--")
                   else "")
            flags[tok[2:]] = val
    return {
        "rdzv_addr": env.get("REPRO_RDZV_ADDR"),
        "role": env.get("REPRO_ROLE"),
        "rank": int(env["REPRO_RANK"]) if "REPRO_RANK" in env else None,
        "env": env,
        "cmd": cmd,
        "flags": flags,
    }


def main(argv: Optional[list] = None) -> list[str]:
    """The launcher CLI: build the spec (``--policy auto`` ranks the
    policy space at #workers / #clients devices per client), emit the
    scripts into ``--outdir``, print and return their paths."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=32)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multipod")
    ap.add_argument("--outdir", default="launch_scripts")
    ap.add_argument("--optimizer", default="sgd",
                    choices=("sgd", "adagrad", "adamw"))
    ap.add_argument("--no-fused-update", action="store_true",
                    help="disable the sharded fused sync path")
    ap.add_argument("--no-flat-exchange", action="store_true",
                    help="per-leaf elastic exchange instead of the packed "
                         "fused kernel")
    ap.add_argument("--bucket-bytes", type=int, default=0)
    ap.add_argument("--wire-dtype", default="f32",
                    choices=("f32", "bf16", "int8"),
                    help="low-precision wire protocol for every worker")
    ap.add_argument("--allreduce", default="",
                    choices=("", "psum", "ring", "multi_ring", "tree",
                             "scatter_gather"),
                    help="intra-client collective ('' = derive like the "
                         "worker CLI: psum, or ring under wire/overlap)")
    ap.add_argument("--num-rings", type=int, default=0,
                    help="concurrent rings for ring-family methods "
                         "(0 = worker default)")
    ap.add_argument("--policy", default=None, choices=("auto",),
                    help="'auto' ranks the collective-policy space with "
                         "the cost model (launch.autotune) at this job's "
                         "geometry and threads the fastest valid policy "
                         "into every client's launch command")
    ap.add_argument("--state-dtype", default="f32",
                    choices=("f32", "bf16"),
                    help="flat optimizer-state stream dtype for every worker")
    ap.add_argument("--overlap", action="store_true",
                    help="backward-overlapped bucketed reduce-scatter for "
                         "every worker (hide the wire leg behind backprop)")
    ap.add_argument("--overlap-buckets", type=int, default=4,
                    help="schedule buckets == backward stages")
    ap.add_argument("--faults", default="",
                    help="deterministic fault schedule for every client "
                         "(core/faults.py string form)")
    ap.add_argument("--barrier-timeout", type=float, default=0.0,
                    help="sync-barrier degradation timeout in seconds "
                         "(0 = block forever)")
    ap.add_argument("--restarts", type=int, default=0,
                    help="per-unit supervised-respawn budget for abnormal "
                         "exits (tcp transport only; 0 = no respawn)")
    ap.add_argument("--restart-backoff", type=float, default=0.05,
                    help="first respawn backoff in seconds (doubles per "
                         "budget-charged respawn)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="durable KV checkpoint cadence in steps "
                         "(0 = no snapshots)")
    ap.add_argument("--restore", default="",
                    help="checkpoint path the in-process train path "
                         "restores from before stepping")
    ap.add_argument("--server-faults", default="",
                    help="fault schedule the SERVER tier evaluates "
                         "(kill@step:unit=R self-kills server R)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every worker and server process "
                         "(default cuda; threaded as --device otherwise)")
    args = ap.parse_args(argv)
    if args.policy == "auto":
        from repro_torch.configs.base import INPUT_SHAPES, get_config
        from repro_torch.launch.autotune import autotune_for_model, format_table

        cfg = get_config(args.arch)
        shape = INPUT_SHAPES.get(args.shape)
        tokens = (shape.seq_len * shape.global_batch if shape is not None
                  else 1 << 20)
        per_client = max(args.workers // max(args.clients, 1), 1)
        result = autotune_for_model(cfg, p=per_client,
                                    tokens_per_step=tokens)
        pol = result.chosen.policy
        print(f"# --policy auto: {len(result.ranked)} valid / "
              f"{len(result.pruned)} pruned at p={per_client}")
        print(format_table(result))
    else:
        pol = CollectivePolicy(
            method=(args.allreduce
                    or ("ring" if (args.wire_dtype != "f32" or args.overlap)
                        else "psum")),
            num_rings=(args.num_rings
                       or (1 if args.overlap else 2)),
            bucket_bytes=args.bucket_bytes or None,
            wire_dtype=(None if args.wire_dtype == "f32"
                        else args.wire_dtype),
            overlap=args.overlap, overlap_buckets=args.overlap_buckets)
    spec = JobSpec(args.workers, args.servers, args.clients, args.arch,
                   args.shape, args.mesh,
                   optimizer=args.optimizer,
                   fused_update=not args.no_fused_update,
                   flat_exchange=not args.no_flat_exchange,
                   state_dtype=args.state_dtype,
                   faults=args.faults,
                   barrier_timeout=args.barrier_timeout,
                   restarts=args.restarts,
                   restart_backoff=args.restart_backoff,
                   checkpoint_every=args.checkpoint_every,
                   restore=args.restore,
                   server_faults=args.server_faults,
                   device=args.device,
                   policy=pol)
    paths = emit_scripts(spec, args.outdir)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    main()
