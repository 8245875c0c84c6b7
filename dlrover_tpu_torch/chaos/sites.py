"""The chaos-site registry: every legal fault-injection site name — the
port's copy of ``dlrover_tpu/chaos/sites.py``, every name kept, so one
fault plan arms the processes of both packages.

The injector matches fault-plan events to instrumented call sites by
string name; a typo on either side would never fire. So
:meth:`~dlrover_tpu_torch.chaos.injector.FaultInjector.get` validates
every plan event's site against :data:`ALL_SITES` and refuses to arm an
unknown one. The port instruments the RPC client and server
(``rpc.client.send``, ``rpc.server.recv``, ``master.partition``) and the
servicer (``master.crash``); the trainer's and storage's sites come with
ROADMAP queue 1, item 5.

Keep this module dependency-free: it is imported by the injector, which
must stay importable from every process with zero side effects.
"""


class ChaosSite:
    """Instrumented fault-injection points (see docs/fault_tolerance.md
    for the per-site fault matrix)."""

    #: RpcClient.call, before the payload is written to the socket.
    RPC_CLIENT_SEND = "rpc.client.send"
    #: RpcServer connection loop, after decode, before dispatch.
    RPC_SERVER_RECV = "rpc.server.recv"
    #: Agent monitor tick over live worker processes (kill/hang).
    AGENT_MONITOR = "agent.monitor"
    #: Trainer step boundary (straggle/raise), detail = step number.
    TRAINER_STEP = "trainer.step"
    #: Checkpoint engine shm snapshot commit (lose), detail = shm name.
    CKPT_SHM = "ckpt.shm"
    #: ChaosStorage write path (corrupt/truncate/drop), detail = path.
    STORAGE_WRITE = "storage.write"
    #: MasterServicer.handle, before dispatch (kill/exit), detail =
    #: request message type name.
    MASTER_CRASH = "master.crash"
    #: Lockdep drill marker: named acquisitions in lock-order tests.
    LOCKDEP_ACQUIRE = "lockdep.acquire"
    #: RescaleCoordinator.get_plan, before answering a survivor's poll
    #: (drop/delay), detail = "plan{id}:rank{n}".
    RESCALE_PLAN_DELIVER = "rescale.plan.deliver"
    #: Worker transition engine, before re-sharding live state onto the
    #: new mesh (abort/delay), detail = "plan{id}".
    RESCALE_TRANSFER = "rescale.transfer"
    #: Agent LinkProbe sample (degrade: scale measured bandwidth down /
    #: inflate RTT by args["factor"]), detail = probe sequence number.
    PROBE_LINK = "probe.link"
    #: Agent preemption-watcher poll (notice): deliver a termination
    #: notice with args["window_s"] grace, then kill the workers
    #: args["kill_after_s"] seconds later (0 = kill before the window
    #: opens; omit/negative = notice without a kill — false alarm).
    #: Detail = node rank.
    PREEMPT_NOTICE = "preempt.notice"
    #: ShardLeaseService.grant, before any shard is popped (drop: the
    #: grant answers empty and the client retries; delay: sleep
    #: args["delay_s"] first), detail = dataset name.
    SHARD_LEASE_DELIVER = "shard.lease.deliver"
    #: ShardLeaseService.tick expiry sweep: force-expire a live lease
    #: as if its TTL lapsed (whole-lease re-dispatch), detail = lease id.
    SHARD_LEASE_EXPIRE = "shard.lease.expire"
    #: RemediationPolicy quarantine action, after the pre-flight and
    #: before the world is touched (deny: skip the action this tick,
    #: exercising the hold/backoff path; delay: sleep ``delay_s``),
    #: detail = "node{rank}".
    REMEDIATION_ACT = "remediation.act"
    #: RpcClient.call asymmetric partition (one-way loss): "drop" tears
    #: the connection down before the request is written (request lost);
    #: "drop_response" writes the request, then severs before reading
    #: the reply — the master executes and caches, the client retries,
    #: and the dedup cache must answer exactly-once. Detail = request
    #: message type name.
    MASTER_PARTITION = "master.partition"
    #: WalSubscribe handler, after the segment is read and before it is
    #: returned (drop: answer empty this pull; truncate: ship the
    #: segment with args["keep_bytes"] (default half) of its tail cut
    #: mid-frame so the standby must detect the torn frame and
    #: re-request from its last durable cursor; delay: sleep
    #: args["delay_s"]). Detail = "seq{n}+{offset}".
    WAL_STREAM = "wal.stream.drop"
    #: BrainPolicy shrink action, after the can_plan_shrink pre-flight
    #: and before the world is touched (deny: skip the action this
    #: tick, exercising the hysteresis/hold path; delay: sleep
    #: ``delay_s``), detail = "node{rank}".
    BRAIN_ACT = "brain.act"
    #: Reserved for unit drills of the injector mechanics themselves
    #: (schedules, journaling): never instrumented in product code.
    TEST_PROBE = "test.probe"
    TEST_PROBE_B = "test.probe.b"


ALL_SITES = frozenset(
    value
    for name, value in vars(ChaosSite).items()
    if not name.startswith("_") and isinstance(value, str)
)


def validate_sites(sites) -> None:
    """Raise ``ValueError`` naming every unregistered site in `sites`."""
    unknown = sorted(set(sites) - ALL_SITES)
    if unknown:
        raise ValueError(
            f"unknown chaos site(s) {unknown}; registered sites are "
            f"{sorted(ALL_SITES)} (chaos/sites.py). A typo'd site would "
            "silently never fire — refusing to arm."
        )
