"""Launch-contract names — the port's copy of ``NodeEnv``
(``dlrover_tpu/common/constants.py``), limited to what the bootstrap
reads."""

from dlrover_tpu_torch.common import env_utils as _env


class NodeEnv:
    """Environment variables the launcher/agent sets for every worker."""

    COORDINATOR_ADDR = _env.COORDINATOR_ADDR.name
    PROCESS_ID = _env.PROCESS_ID.name
    NUM_PROCESSES = _env.NUM_PROCESSES.name
    LOCAL_RANK = _env.LOCAL_RANK.name
