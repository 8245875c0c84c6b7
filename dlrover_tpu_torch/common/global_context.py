"""Master-side tunables singleton — the port's copy of
``dlrover_tpu/common/global_context.py``."""

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.singleton import Singleton


class Context(Singleton):
    def __init__(self):
        self.master_port = 0
        self.reporting_interval = 15.0
        self.seconds_to_wait_failed_node = 120.0
        self.seconds_for_stable_worker_count = 60.0
        self.seconds_to_wait_pending_node = 900.0
        self.hang_detection_seconds = env_utils.HANG_DETECTION_SECS.get()
        self.heartbeat_timeout = env_utils.HEARTBEAT_TIMEOUT.get()
        self.node_monitor_interval = env_utils.NODE_MONITOR_INTERVAL.get()
        self.relaunch_always = False
        self.max_relaunch_count = 3
        self.rdzv_waiting_timeout = 30.0
        self.rdzv_lastcall_timeout = 3.0
        self.device_check_timeout = env_utils.DEVICE_CHECK_TIMEOUT.get()
        self.straggler_time_ratio = 2.0
        self.auto_scale_enabled = False
        self.checkpoint_gc_keep = 3
        # Opt-in: let the master push tuned dataloader configs to workers
        # (reference gates auto-tuning the same way).
        self.auto_paral_tuning = env_utils.AUTO_PARAL.get()


def get_context() -> Context:
    return Context.singleton_instance()
