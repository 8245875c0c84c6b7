"""Shared helpers of the port: logger, env knobs, launch-contract names."""
