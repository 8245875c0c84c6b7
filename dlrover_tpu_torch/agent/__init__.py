"""Agent-side pieces of the port (counterpart of ``dlrover_tpu/agent/``):
the flash checkpoint's saver and the master client. The agent process
itself comes with ROADMAP queue 1, item 3."""
