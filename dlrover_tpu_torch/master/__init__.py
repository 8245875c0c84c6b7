"""The job master's core — the port's copy of ``dlrover_tpu/master/``'s
servicer, rendezvous managers, node manager, kv store, sync service,
speed and error monitors and state store, wire-compatible with the JAX
master. ``python -m dlrover_tpu_torch.master.main`` boots it."""
