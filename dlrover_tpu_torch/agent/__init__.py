"""Agent-side pieces of the port (counterpart of ``dlrover_tpu/agent/``):
the flash checkpoint's saver. The agent process itself comes with
ROADMAP queue 1, item 6."""
