"""Job events — the port's copy of ``EventKind``, ``JobEvent`` and
``emit`` (``dlrover_tpu/observability/events.py``). The event log, the
goodput ledger, the reporter and the exporter come with ROADMAP queue 1,
item 5."""
