"""Typed client for the master control plane — the port's copy of
``dlrover_tpu/agent/master_client.py``: the singleton the agent and the
trainer processes use for rendezvous, tasks, kv-store, metrics, failures
and sync barriers.

It speaks the JAX master's wire (``common/rpc.py``), so it drives either
package's master. Every method of the JAX client is here; against the
port's master, a method whose handler needs a part that master leaves
out raises the master's error, which names its ROADMAP queue 1 item.
"""

import os
import time
from typing import Dict, Optional, Tuple

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.backoff import ExponentialBackoff
from dlrover_tpu_torch.common.constants import NodeEnv, NodeStatus
from dlrover_tpu_torch.common.lockdep import instrumented_lock
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.rpc import RpcClient

#: The JAX client's settings for following a master under the hot
#: standby, which the port leaves out (ROADMAP queue 1, item 10's rest).
HA_SETTINGS = (env_utils.MASTER_HA_DIR.name,
               "DLROVER_TPU_MASTER_HA_ENDPOINT_FILE")


class MasterClient:
    _instance: Optional["MasterClient"] = None

    def __init__(self, master_addr: str, node_id: int = 0,
                 node_type: str = "worker"):
        for name in HA_SETTINGS:
            if os.environ.get(name):
                raise NotImplementedError(
                    f"{name} asks the client to follow a master under the "
                    "hot standby, which the port leaves out (ROADMAP queue "
                    "1, item 10's rest)")
        self._client = RpcClient(master_addr)
        self._client.on_incarnation_change = self._on_master_incarnation_change
        self._node_id = node_id
        self._node_type = node_type
        self.master_addr = master_addr
        # Shard tasks fetched but not yet acked, keyed by
        # (dataset, task_id) — what a fenced client re-reports to the
        # new master incarnation so records it holds are neither
        # re-dispatched to someone else nor dropped.
        self._inflight_tasks: Dict[Tuple[str, int], m.ShardTask] = {}
        self._inflight_lock = instrumented_lock("master_client.inflight")
        self.fenced_count = 0

    # ---------------- singleton wiring ----------------
    @classmethod
    def singleton_instance(cls) -> "MasterClient":
        if cls._instance is None:
            addr = os.getenv(NodeEnv.MASTER_ADDR, "")
            if not addr:
                raise RuntimeError(
                    f"{NodeEnv.MASTER_ADDR} is not set; no master to talk to"
                )
            node_id = int(os.getenv(NodeEnv.NODE_ID, 0))
            cls._instance = cls(addr, node_id)
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = None

    def _fill(self, req: m.BaseRequest) -> m.BaseRequest:
        req.node_id = self._node_id
        req.node_type = self._node_type
        return req

    def _call(self, req, timeout: Optional[float] = None):
        return self._client.call(self._fill(req), timeout=timeout)

    # ---------------- incarnation fencing ----------------
    def _on_master_incarnation_change(self, old: int, new: int):
        """The master restarted (response stamps jumped old -> new):
        re-register this node with the new incarnation and re-report
        every in-flight shard task. Invoked by the transport outside its
        lock, on the thread that observed the change; RPCs issued here
        are ordinary calls against the new master."""
        with self._inflight_lock:
            tasks = list(self._inflight_tasks.values())
        self.fenced_count += 1
        logger.warning(
            "master incarnation changed %s -> %s: re-registering node %s "
            "and re-reporting %s in-flight shard task(s)",
            old, new, self._node_id, len(tasks),
        )
        try:
            self.report_node_status(NodeStatus.RUNNING)
            self.report_heartbeat()
        except Exception as e:
            logger.warning("fencing re-registration failed: %s", e)
        for task in tasks:
            try:
                resp = self._call(m.TaskHoldReport(
                    dataset_name=task.dataset_name,
                    task_id=task.task_id,
                    start=task.start,
                    end=task.end,
                    shard_name=task.shard_name,
                    record_indices=task.record_indices,
                ))
                if resp is not None and not resp.success:
                    # The new master refused the hold (the task was
                    # already acked or re-dispatched): drop our claim so
                    # a later report_task doesn't double-account it.
                    logger.warning(
                        "master rejected hold of shard task %s/%s; "
                        "dropping the local claim",
                        task.dataset_name, task.task_id,
                    )
                    with self._inflight_lock:
                        self._inflight_tasks.pop(
                            (task.dataset_name, task.task_id), None
                        )
            except Exception as e:
                logger.warning(
                    "fencing hold-report of task %s/%s failed: %s",
                    task.dataset_name, task.task_id, e,
                )

    # ---------------- rendezvous ----------------
    def join_rendezvous(self, rdzv_name: str, node_rank: int,
                        local_world_size: int = 1) -> int:
        return self._call(
            m.JoinRendezvous(
                rdzv_name=rdzv_name,
                node_rank=node_rank,
                local_world_size=local_world_size,
            )
        )

    def get_comm_world(
        self, rdzv_name: str, node_rank: Optional[int] = None
    ) -> Tuple[int, int, Dict[int, int]]:
        rank = self._node_id if node_rank is None else node_rank
        resp: m.CommWorld = self._call(
            m.CommWorldRequest(rdzv_name=rdzv_name, node_rank=rank)
        )
        return resp.round, resp.group, resp.world

    def num_nodes_waiting(self, rdzv_name: str) -> int:
        return self._call(m.WaitingNodeNumRequest(rdzv_name=rdzv_name))

    def world_stale(self, rdzv_name: str, round_: int) -> bool:
        """True when the agent's current round was invalidated by a
        member death and survivors must re-form."""
        return bool(self._call(
            m.WorldStatusRequest(rdzv_name=rdzv_name, round=round_)
        ))

    # ---------------- live rescale ----------------
    def get_rescale_plan(self, rdzv_name: str, node_rank: int,
                         round_: int) -> m.RescalePlan:
        """Poll for an active in-place rescale plan covering this node
        (``plan.exists`` is False when there is none)."""
        return self._call(
            m.RescalePlanRequest(
                rdzv_name=rdzv_name, node_rank=node_rank, round=round_,
            )
        )

    def report_rescale_ack(self, plan_id: int, node_rank: int,
                           ok: bool, error: str = ""):
        return self._call(
            m.RescaleAck(
                plan_id=plan_id, node_rank=node_rank, ok=ok, error=error,
            )
        )

    def elect_ckpt_writer(self, group: str, epoch: int,
                          rank: int) -> m.CkptWriterLease:
        """Propose this replica as the checkpoint writer for `group`.

        First claimant wins; the returned lease names the elected owner
        (``lease.owner_rank``), which every proposer of the same
        (group, epoch) observes identically."""
        return self._call(
            m.CkptWriterElect(group=group, epoch=epoch, rank=rank)
        )

    # ---------------- preemption plane ----------------
    def report_preemption_notice(self, node_rank: int, deadline_ts: float,
                                 grace_s: float, source: str,
                                 reason: str = "") -> m.Response:
        """Report a known-ahead termination notice for this node.

        Journaled + deduped on the master: retries and multiple sources
        firing for the same node collapse to one armed notice."""
        return self._call(
            m.PreemptionNotice(
                node_rank=node_rank, deadline_ts=deadline_ts,
                grace_s=grace_s, source=source, reason=reason,
            )
        )

    def report_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float, node_unit: int):
        return self._call(
            m.RendezvousParams(
                min_nodes=min_nodes,
                max_nodes=max_nodes,
                waiting_timeout=waiting_timeout,
                node_unit=node_unit,
            )
        )

    # ---------------- device check ----------------
    def report_check_result(self, node_rank: int, normal: bool,
                            elapsed: float, round_: int = 0):
        return self._call(
            m.DeviceCheckResult(
                node_rank=node_rank, normal=normal, elapsed_time=elapsed,
                round=round_,
            )
        )

    def get_fault_nodes(self):
        resp: m.DiagnosisResult = self._call(m.FaultNodesRequest())
        return resp.nodes, resp.done, resp.completed_rounds

    def get_stragglers(self):
        resp: m.DiagnosisResult = self._call(m.StragglersRequest())
        return resp.nodes, resp.done, resp.completed_rounds

    # ---------------- kv store ----------------
    def kv_store_set(self, key: str, value: bytes):
        return self._call(m.KVStoreSet(key=key, value=value))

    def kv_store_get(self, key: str) -> Optional[bytes]:
        return self._call(m.KVStoreGet(key=key))

    def kv_store_add(self, key: str, amount: int = 1) -> int:
        return self._call(m.KVStoreAdd(key=key, amount=amount))

    def kv_store_multi_get(self, keys) -> Dict[str, Optional[bytes]]:
        return self._call(m.KVStoreMultiGet(keys=tuple(keys)))

    def kv_store_delete(self, key: str):
        return self._call(m.KVStoreDelete(key=key))

    def kv_store_wait(self, keys, timeout: float = 300.0) -> Dict[str, bytes]:
        # Jittered backoff, not a fixed 0.1 s poll: every worker of the
        # job waits on the same barrier keys at the same moment, and
        # synchronized polling multiplies master RPC load by world size.
        deadline = time.monotonic() + timeout
        backoff = ExponentialBackoff(initial=0.05, max_delay=1.0)
        while True:
            values = self.kv_store_multi_get(keys)
            if all(v is not None for v in values.values()):
                return values
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            backoff.sleep(remaining)
        raise TimeoutError(f"kv keys {keys} not all set within {timeout}s")

    # ---------------- data sharding ----------------
    def report_dataset_shard_params(
        self,
        dataset_name: str,
        dataset_size: int,
        shard_size: int,
        num_epochs: int = 1,
        shuffle: bool = False,
        storage_type: str = "table",
    ):
        return self._call(
            m.DatasetShardParams(
                dataset_name=dataset_name,
                dataset_size=dataset_size,
                shard_size=shard_size,
                num_epochs=num_epochs,
                shuffle=shuffle,
                storage_type=storage_type,
            )
        )

    def get_task(self, dataset_name: str) -> m.ShardTask:
        task = self._call(m.TaskRequest(dataset_name=dataset_name))
        if task is not None and task.exists:
            with self._inflight_lock:
                self._inflight_tasks[(task.dataset_name, task.task_id)] = task
        return task

    def report_task(self, dataset_name: str, task_id: int, success: bool = True):
        resp = self._call(
            m.TaskReport(dataset_name=dataset_name, task_id=task_id,
                         success=success)
        )
        with self._inflight_lock:
            self._inflight_tasks.pop((dataset_name, task_id), None)
        return resp

    def request_lease(self, dataset_name: str,
                      max_shards: int = 0) -> m.ShardLease:
        """Bulk-lease up to `max_shards` shards (0 = the master's
        per-dataset target). The agent broker's refill path — NOT
        tracked in _inflight_tasks: lease recovery is the master's TTL
        plus the broker re-leasing after an unknown-lease answer, not
        the per-task hold-report fencing."""
        return self._call(
            m.LeaseRequest(dataset_name=dataset_name, max_shards=max_shards)
        )

    def report_lease(self, dataset_name: str, lease_id: int, done_ids,
                     failed_ids=(), release: bool = False) -> m.Response:
        """Batched completion/failure acks for one lease; also the
        renewal (any report renews the TTL) and the release."""
        return self._call(
            m.LeaseReport(
                dataset_name=dataset_name, lease_id=lease_id,
                done_ids=list(done_ids), failed_ids=list(failed_ids),
                release=release,
            )
        )

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp: m.ShardCheckpoint = self._call(
            m.ShardCheckpointRequest(dataset_name=dataset_name)
        )
        return resp.content

    def get_dataset_epoch(self, dataset_name: str) -> int:
        return self._call(m.DatasetEpochRequest(dataset_name=dataset_name))

    # ---------------- metrics / lifecycle ----------------
    def report_global_step(self, step: int, timestamp: float = 0.0):
        return self._call(m.GlobalStep(step=step, timestamp=timestamp or time.time()))

    def report_resource_stats(self, cpu_percent: float, used_memory_mb: int,
                              device_stats=None):
        return self._call(
            m.NodeResourceStats(
                cpu_percent=cpu_percent,
                used_memory_mb=used_memory_mb,
                device_stats=device_stats or [],
            )
        )

    def report_model_info(self, params_count: int, flops_per_step: float,
                          batch_size: int = 0, seq_len: int = 0, extra=None):
        return self._call(
            m.ModelInfo(
                params_count=params_count,
                flops_per_step=flops_per_step,
                batch_size=batch_size,
                seq_len=seq_len,
                extra=extra or {},
            )
        )

    def report_failure(self, error_data: str, level: str = "process_error",
                       restart_count: int = 0):
        try:
            return self._call(
                m.NodeFailure(
                    error_data=error_data, level=level,
                    restart_count=restart_count,
                )
            )
        except Exception as e:
            logger.warning("failed reporting failure to master: %s", e)

    def report_heartbeat(self):
        return self._call(m.NodeHeartbeat(timestamp=time.time()))

    def report_beat(self, step: int = -1, step_ts: float = 0.0,
                    probe: Optional[Dict] = None):
        """The coalesced periodic beat: heartbeat + newest step progress
        + latest probe sample in ONE RPC (see ``m.AgentBeat``)."""
        return self._call(m.AgentBeat(
            timestamp=time.time(), step=step, step_ts=step_ts,
            probe=probe or {},
        ))

    def report_events(self, events, timeout: Optional[float] = None):
        """Forward a batch of JobEvents to the master's event log."""
        return self._call(
            m.EventReport(events=list(events)), timeout=timeout
        )

    def report_node_status(self, status: str, exit_reason: str = ""):
        return self._call(
            m.NodeStatusReport(status=status, exit_reason=exit_reason)
        )

    # ---------------- sync ----------------
    def join_sync(self, sync_name: str, worker_rank: int = 0) -> bool:
        return self._call(m.SyncJoin(sync_name=sync_name, worker_rank=worker_rank))

    def sync_finished(self, sync_name: str) -> bool:
        return self._call(m.SyncFinish(sync_name=sync_name))

    def barrier(self, sync_name: str, notify: bool = False) -> bool:
        return self._call(m.SyncBarrierRequest(sync_name=sync_name, notify=notify))

    # ---------------- config / exit ----------------
    def get_paral_config(self) -> m.ParallelConfig:
        return self._call(m.ParallelConfigRequest())

    def report_job_exit(self, success: bool, reason: str = ""):
        return self._call(m.JobExitRequest(success=success, reason=reason))

    def close(self):
        self._client.close()


def build_master_client(master_addr: str = "", node_id: int = 0) -> MasterClient:
    if master_addr:
        return MasterClient(master_addr, node_id)
    return MasterClient.singleton_instance()
